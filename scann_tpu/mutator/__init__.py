"""Dynamic index mutations.

Host-side mutable state (the C++ core in scann_tpu/native, pure-Python
fallback) + snapshot-swap searching:

  - ``MutationBuffer`` — bounded concurrent mutation queue
    (reference: src/mutator/mod.rs:76-150).
  - ``MutableDataset`` — concurrent add/update/remove over an append-only
    slab with a deleted bitset (reference: mod.rs:233-491). Where the
    reference uses RCU/ArcSwap snapshots, device arrays *are* immutable
    snapshots: ``snapshot()`` hands (rows, deleted) to the device uploader.
  - ``IncrementalUpdater`` — atomic index swap + rebuild threshold
    (reference: mod.rs:494-546).
  - ``DynamicSearcher`` — serving wrapper: a main index built from the last
    snapshot plus an exact brute-force delta over rows added since, deleted
    rows masked out of both; rebuilds when the delta exceeds the threshold.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError
from scann_tpu.native import load_native


class MutationKind(enum.IntEnum):
    ADD = 0
    REMOVE = 1
    UPDATE = 2


@dataclasses.dataclass
class Mutation:
    """(reference: src/mutator/mod.rs:20-72)."""

    kind: MutationKind
    index: int
    data: Optional[np.ndarray] = None
    timestamp: int = 0

    @classmethod
    def add(cls, index: int, data, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.ADD, index, np.asarray(data, np.float32), timestamp)

    @classmethod
    def remove(cls, index: int, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.REMOVE, index, None, timestamp)

    @classmethod
    def update(cls, index: int, data, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.UPDATE, index, np.asarray(data, np.float32), timestamp)


class MutationBuffer:
    """Bounded concurrent mutation queue; native-backed when available."""

    def __init__(self, max_buffer_size: int = 1024, dim: int = 0):
        self.max_buffer_size = int(max_buffer_size)
        self._dim = int(dim)
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.mbuf_create(self.max_buffer_size)
        else:
            self._h = None
            self._q: List[Mutation] = []
            self._lock = threading.Lock()
            self._ts = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.mbuf_destroy(self._h)
            self._h = None

    def push(self, m: Mutation) -> bool:
        if self._lib is not None:
            import ctypes
            data_ptr = None
            dim = 0
            if m.data is not None:
                arr = np.ascontiguousarray(m.data, dtype=np.float32)
                data_ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                dim = arr.size
                # flush() sizes its output rows from self._dim: learn it
                # from pushed payloads so a dim=0 construction still
                # round-trips vectors (parity with the Python fallback)
                if dim > self._dim:
                    self._dim = int(dim)
            return self._lib.mbuf_push(self._h, int(m.kind), m.index, data_ptr, dim) == 0
        with self._lock:
            if len(self._q) >= self.max_buffer_size:
                return False
            m.timestamp = self._ts
            self._ts += 1
            self._q.append(m)
            return True

    def add(self, index: int, data) -> bool:
        return self.push(Mutation.add(index, data))

    def remove(self, index: int) -> bool:
        return self.push(Mutation.remove(index))

    def update(self, index: int, data) -> bool:
        return self.push(Mutation.update(index, data))

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.mbuf_len(self._h))
        with self._lock:
            return len(self._q)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def should_flush(self) -> bool:
        return len(self) >= self.max_buffer_size

    def flush(self, dim: Optional[int] = None) -> List[Mutation]:
        """Drain all queued mutations in order."""
        if self._lib is not None:
            import ctypes
            dim = dim if dim is not None else self._dim
            out = []
            kind = ctypes.c_int32()
            idx = ctypes.c_uint64()
            ts = ctypes.c_uint64()
            buf = np.zeros(max(dim, 1), dtype=np.float32)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            while True:
                buf[:] = 0.0  # entries may carry fewer floats than dim
                if self._lib.mbuf_pop(self._h, ctypes.byref(kind),
                                      ctypes.byref(idx), ctypes.byref(ts),
                                      ptr, dim) != 0:
                    break
                k = MutationKind(kind.value)
                data = buf[:dim].copy() if k != MutationKind.REMOVE else None
                out.append(Mutation(k, idx.value, data, ts.value))
            return out
        with self._lock:
            out, self._q = self._q, []
            return out


class _PyDatasetCore:
    """Pure-Python fallback matching the native core's semantics."""

    def __init__(self, dim: int, capacity: int = 64):
        self.dim = dim
        self._lock = threading.RLock()
        self._data = np.zeros((capacity, dim), dtype=np.float32)
        self._deleted = np.zeros(capacity, dtype=np.uint8)
        self._rows = 0
        self._live = 0

    def add(self, v: np.ndarray) -> int:
        with self._lock:
            if self._rows >= len(self._data):
                self._data = np.concatenate([self._data, np.zeros_like(self._data)])
                self._deleted = np.concatenate([self._deleted, np.zeros_like(self._deleted)])
            self._data[self._rows] = v
            self._deleted[self._rows] = 0
            self._rows += 1
            self._live += 1
            return self._rows - 1

    def remove(self, i: int) -> bool:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                self._deleted[i] = 1
                self._live -= 1
                return True
            return False

    def update(self, i: int, v: np.ndarray) -> bool:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                self._data[i] = v
                return True
            return False

    def get(self, i: int) -> Optional[np.ndarray]:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                return self._data[i].copy()
            return None

    def exists(self, i: int) -> bool:
        with self._lock:
            return 0 <= i < self._rows and not self._deleted[i]

    def size(self) -> int:
        with self._lock:
            return self._live

    def rows(self) -> int:
        with self._lock:
            return self._rows

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return self._data[: self._rows].copy(), self._deleted[: self._rows].copy()

    def compact(self) -> int:
        with self._lock:
            keep = self._deleted[: self._rows] == 0
            kept = self._data[: self._rows][keep]
            self._data[: len(kept)] = kept
            self._deleted[: self._rows] = 0
            self._rows = len(kept)
            self._live = len(kept)
            return self._rows


class _NativeDatasetCore:
    """ctypes wrapper over the C++ MDS."""

    def __init__(self, lib, dim: int, capacity: int = 64):
        self._lib = lib
        self.dim = dim
        self._h = lib.mds_create(dim, capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mds_destroy(self._h)
            self._h = None

    def _fptr(self, arr):
        import ctypes
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def add(self, v: np.ndarray) -> int:
        arr = np.ascontiguousarray(v, dtype=np.float32)
        return int(self._lib.mds_add(self._h, self._fptr(arr)))

    def remove(self, i: int) -> bool:
        return self._lib.mds_remove(self._h, i) == 0

    def update(self, i: int, v: np.ndarray) -> bool:
        arr = np.ascontiguousarray(v, dtype=np.float32)
        return self._lib.mds_update(self._h, i, self._fptr(arr)) == 0

    def get(self, i: int) -> Optional[np.ndarray]:
        out = np.zeros(self.dim, dtype=np.float32)
        if self._lib.mds_get(self._h, i, self._fptr(out)) == 0:
            return out
        return None

    def exists(self, i: int) -> bool:
        return bool(self._lib.mds_exists(self._h, i))

    def size(self) -> int:
        return int(self._lib.mds_size(self._h))

    def rows(self) -> int:
        return int(self._lib.mds_rows(self._h))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        import ctypes
        r = self.rows()
        data = np.zeros((max(r, 1), self.dim), dtype=np.float32)
        deleted = np.zeros(max(r, 1), dtype=np.uint8)
        got = self._lib.mds_snapshot(
            self._h, self._fptr(data),
            deleted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), r)
        return data[:got], deleted[:got]

    def compact(self) -> int:
        return int(self._lib.mds_compact(self._h))


class MutableDataset:
    """Concurrent mutable dataset (reference: src/mutator/mod.rs:233-491)."""

    def __init__(self, dimensionality: int, use_native: bool = True):
        self.dim = int(dimensionality)
        lib = load_native() if use_native else None
        if lib is not None:
            self._core = _NativeDatasetCore(lib, self.dim)
            self.native = True
        else:
            self._core = _PyDatasetCore(self.dim)
            self.native = False
        self._mutations = MutationBuffer(1 << 20, dim=self.dim)
        # True once the bounded buffer rejected a push: the delta log is
        # no longer a complete record and incremental consumers must
        # resync from snapshot() (flush_mutations resets the flag)
        self.mutation_log_overflowed = False

    @classmethod
    def from_dataset(cls, dataset: DenseDataset, use_native: bool = True) -> "MutableDataset":
        m = cls(dataset.dimensionality, use_native)
        for row in dataset.numpy():
            m._core.add(row)
        return m

    def _log(self, m: Mutation) -> None:
        """Record a mutation in the bounded delta log; on overflow, flag
        (and warn once) rather than silently dropping — the core already
        holds the change, only incremental replay loses completeness."""
        if not self._mutations.push(m) and not self.mutation_log_overflowed:
            self.mutation_log_overflowed = True
            import warnings

            warnings.warn(
                "MutableDataset mutation log overflowed; incremental "
                "consumers must resync from snapshot() (the dataset "
                "itself is unaffected)", RuntimeWarning, stacklevel=3)

    # -- mutations ---------------------------------------------------------
    def add(self, data) -> int:
        v = np.asarray(data, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ScannError.invalid_argument(f"point shape {v.shape} != ({self.dim},)")
        idx = self._core.add(v)
        self._log(Mutation.add(idx, v))
        return idx

    def remove(self, index: int) -> None:
        if not self._core.remove(index):
            raise ScannError.not_found(f"index {index} not found or already removed")
        self._log(Mutation.remove(index))

    def update(self, index: int, data) -> None:
        v = np.asarray(data, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ScannError.invalid_argument(f"point shape {v.shape} != ({self.dim},)")
        if not self._core.update(index, v):
            raise ScannError.not_found(f"index {index} not found")
        self._log(Mutation.update(index, v))

    # -- reads -------------------------------------------------------------
    def get(self, index: int) -> Optional[np.ndarray]:
        return self._core.get(index)

    get_fast = get

    def get_batch(self, indices) -> List[Optional[np.ndarray]]:
        return [self._core.get(int(i)) for i in indices]

    def exists(self, index: int) -> bool:
        return self._core.exists(index)

    @property
    def size(self) -> int:
        return self._core.size()

    @property
    def total_rows(self) -> int:
        return self._core.rows()

    @property
    def dimensionality(self) -> int:
        return self.dim

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [R, D] f32, deleted [R] u8) immutable copy for device upload."""
        return self._core.snapshot()

    def flush_mutations(self) -> List[Mutation]:
        out = self._mutations.flush(self.dim)
        self.mutation_log_overflowed = False
        return out

    def compact(self) -> int:
        # drain through flush_mutations so a prior log overflow clears:
        # compaction starts a fresh delta epoch
        self.flush_mutations()
        return self._core.compact()

    def to_dense_dataset(self) -> DenseDataset:
        data, deleted = self.snapshot()
        return DenseDataset(data[deleted == 0])


class IncrementalUpdater:
    """Atomic index swap + rebuild threshold (reference: mod.rs:494-546)."""

    def __init__(self, index, rebuild_threshold: int = 1000):
        self._index = index
        self._lock = threading.Lock()
        self.rebuild_threshold = int(rebuild_threshold)
        self._pending: List[Mutation] = []

    def load_index(self):
        with self._lock:
            return self._index

    def store_index(self, new_index) -> None:
        with self._lock:
            self._index = new_index

    def queue_mutation(self, m: Mutation) -> None:
        with self._lock:
            self._pending.append(m)

    def needs_rebuild(self) -> bool:
        with self._lock:
            return len(self._pending) >= self.rebuild_threshold

    def get_pending_mutations(self) -> List[Mutation]:
        with self._lock:
            return list(self._pending)

    def reset_rebuild_counter(self) -> None:
        with self._lock:
            self._pending.clear()


def _dynamic_search_kernel(queries, snap_db, cand_ids, extra_rows,
                           extra_ids, extra_valid, eps, *, k, measure):
    """One device program for the dynamic merge: exact rescoring of main
    candidates (gathered on device from the snapshot) + brute force over the
    extra slab + dedup + top-k. Only queries, candidate ids and the (small)
    extra slab cross the host-device boundary per call — the snapshot array
    stays resident between rebuilds."""
    import functools

    import jax

    global _DYNAMIC_KERNEL
    if _DYNAMIC_KERNEL is None:
        from scann_tpu.ops.distances import gathered_distances, many_to_many
        from scann_tpu.ops.topk import top_k_smallest
        from scann_tpu.types import MASKED_DISTANCE

        @functools.partial(jax.jit, static_argnames=("k", "measure"))
        def kern(queries, snap_db, cand_ids, extra_rows, extra_ids,
                 extra_valid, eps, *, k, measure):
            import jax.numpy as jnp

            # rows updated since build are dup-masked below (their current
            # value lives in the extra slab), so the stale snapshot gather is
            # correct for every candidate that survives masking
            cand_rows = snap_db[jnp.clip(cand_ids, 0, snap_db.shape[0] - 1)]
            cd = gathered_distances(measure, queries, cand_rows)
            cand_ok = cand_ids >= 0
            # a candidate that also sits in the extra slab keeps only the
            # (authoritative, current-data) extra copy
            dup = jnp.any(
                cand_ids[:, :, None] == jnp.where(extra_valid, extra_ids,
                                                  -2)[None, None, :], axis=-1)
            cd = jnp.where(cand_ok & ~dup, cd, MASKED_DISTANCE)
            from scann_tpu.ops.distances import DistanceMeasure
            if measure in (DistanceMeasure.SQUARED_L2, DistanceMeasure.L2):
                # Exact diff formulation: the matmul+norms form cancels
                # catastrophically for near-duplicate rows (the delta slab's
                # common case — an update followed by a search for it).
                # Chunked scan bounds the [B, chunk, D] broadcast on-chip.
                chunks = extra_rows.reshape(-1, 256, extra_rows.shape[-1])

                def _chunk(_, rows):
                    d = jnp.sum(
                        (queries[:, None, :] - rows[None, :, :]) ** 2, -1)
                    return None, d

                _, eds = jax.lax.scan(_chunk, None, chunks)
                ed = jnp.moveaxis(eds, 0, 1).reshape(queries.shape[0], -1)
                if measure == DistanceMeasure.L2:
                    ed = jnp.sqrt(ed)
            else:
                ed = many_to_many(measure, queries, extra_rows)
            ed = jnp.where(extra_valid[None, :], ed, MASKED_DISTANCE)
            all_d = jnp.concatenate([cd, ed], axis=1)
            all_i = jnp.concatenate(
                [cand_ids,
                 jnp.broadcast_to(extra_ids[None, :],
                                  (queries.shape[0], extra_ids.shape[0]))],
                axis=1)
            vals, pos = top_k_smallest(all_d, k)
            idx = jnp.take_along_axis(all_i, pos, axis=1)
            # single-stage exact merge: the tighter of the pre/post
            # epsilons applies, SearchParameters.effective_epsilon()
            # semantics (reference: src/brute_force/top_k.rs:263-393)
            missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
            return (jnp.where(missing, jnp.inf, vals),
                    jnp.where(missing, -1, idx))

        _DYNAMIC_KERNEL = kern
    return _DYNAMIC_KERNEL(queries, snap_db, cand_ids, extra_rows,
                           extra_ids, extra_valid, eps, k=k, measure=measure)


_DYNAMIC_KERNEL = None


class DynamicSearcher:
    """Serving wrapper: main index over the last snapshot + exact delta.

    ``searcher_factory(DenseDataset) -> Searcher`` builds the main index.
    Adds since the last rebuild are searched exactly (brute force over the
    delta block); removes/updates mask or override snapshot rows. A rebuild
    folds the delta in. This realizes the reference's
    snapshot-swap + amortized-rebuild design on immutable device arrays.
    """

    def __init__(self, dataset: DenseDataset,
                 searcher_factory: Callable[[DenseDataset], "object"],
                 rebuild_threshold: int = 1000,
                 distance_measure=None):
        self._factory = searcher_factory
        self._mutable = MutableDataset.from_dataset(dataset)
        self.rebuild_threshold = int(rebuild_threshold)
        # None -> read from the built searcher (falls back to squared-L2);
        # delta scoring and rescoring always use this measure
        self._distance_measure = distance_measure
        self._lock = threading.Lock()
        self._rebuild()

    def _rebuild(self):
        data, deleted = self._mutable.snapshot()
        self._snapshot_rows = len(data)
        # snapshot rows stay device-resident between rebuilds; per-search
        # uploads are then just queries + candidate ids + the small delta slab
        self._snapshot_ds = DenseDataset(data)
        self._main = self._factory(self._snapshot_ds)
        self._mutable.flush_mutations()
        # rows updated since build: the main index ranks them by their stale
        # snapshot vector, so they are rescored as explicit delta candidates
        self._updated_since_build = set()
        # candidate invalidation mask: deleted-at-build rows (the factory
        # indexes their stale vectors) plus any snapshot row removed later
        self._cand_invalid = deleted.astype(bool)
        # extra-slab device cache (built lazily, invalidated per mutation)
        self._extra_cache = None

    # -- mutations ----------------------------------------------------------
    def add(self, data) -> int:
        with self._lock:
            idx = self._mutable.add(data)
            self._extra_cache = None
            self._maybe_rebuild()
            return idx

    def remove(self, index: int) -> None:
        with self._lock:
            self._mutable.remove(index)
            if index < self._snapshot_rows:
                self._cand_invalid[index] = True
            self._extra_cache = None
            self._maybe_rebuild()

    def update(self, index: int, data) -> None:
        with self._lock:
            self._mutable.update(index, data)
            if index < self._snapshot_rows:
                self._updated_since_build.add(int(index))
            self._extra_cache = None
            self._maybe_rebuild()

    def _extra_slab(self, d: int):
        """Device-resident delta slab (adds since build + updated rows),
        cached between mutations so per-search host work is O(1) on an
        unchanged index (a per-search get_batch loop would be O(delta)
        host work per query batch)."""
        if self._extra_cache is None:
            import jax.numpy as jnp

            snap_rows, total_rows = self._snapshot_rows, self._mutable.total_rows
            extra_ids = np.concatenate([
                np.arange(snap_rows, total_rows, dtype=np.int64),
                np.fromiter(sorted(self._updated_since_build), np.int64,
                            len(self._updated_since_build)),
            ])
            e_pad = -(-max(len(extra_ids), 1) // 256) * 256
            extra_valid = np.zeros(e_pad, bool)
            extra_rows = np.zeros((e_pad, d), np.float32)
            for j, row in enumerate(self._mutable.get_batch(extra_ids)):
                if row is not None:
                    extra_valid[j] = True
                    extra_rows[j] = row
            ids_pad = np.zeros(e_pad, np.int64)
            ids_pad[: len(extra_ids)] = extra_ids
            self._extra_cache = (
                jnp.asarray(extra_rows),
                jnp.asarray(ids_pad.astype(np.int32)),
                jnp.asarray(extra_valid),
                ids_pad, extra_valid)
        return self._extra_cache

    def _maybe_rebuild(self):
        if len(self._mutable._mutations) >= self.rebuild_threshold:
            self._rebuild()

    @property
    def size(self) -> int:
        return self._mutable.size

    def force_rebuild(self) -> None:
        with self._lock:
            self._rebuild()

    # -- search -------------------------------------------------------------
    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional["object"] = None,
                              allow_mask=None):
        """Main-index candidates + exact device scoring of the delta slab.

        One jitted program per (B, fetch, extra-bucket) shape: exact
        rescoring of main candidates from *current* data (handles rows
        updated since build), brute force over the extra slab (delta adds +
        updated rows), dedup, and the final top-k — no per-query host loop
        (reference semantics: src/mutator/mod.rs:494-546).

        ``params`` (SearchParameters) and ``allow_mask`` apply exactly as on
        a static ``Searcher`` (reference applies SearchParameters on every
        search path, src/searcher.rs:148-186): fetch-quality knobs are
        forwarded to the main index; epsilon thresholds apply to the final
        exact merge (single-stage semantics, ``effective_epsilon()``); the
        allowlist filters both main candidates and the delta slab by point
        id.
        """
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b, d = queries.shape
        eps = (params.effective_epsilon() if params is not None
               else np.float32(np.inf))
        # epsilons are applied here on current-data exact distances; strip
        # them from the params forwarded to the main index (its thresholds
        # would act on stale snapshot distances and could starve the
        # adaptive fetch loop below)
        main_params = None
        if params is not None:
            main_params = dataclasses.replace(
                params, pre_reordering_epsilon=None,
                post_reordering_epsilon=None)
        with self._lock:
            snap_rows = self._snapshot_rows
            total_rows = self._mutable.total_rows
            measure = self._measure_of_main()
            mask_all = None
            if allow_mask is not None:
                mask_all = np.zeros(total_rows, bool)
                m = np.asarray(allow_mask, bool)[:total_rows]
                mask_all[: len(m)] = m
            # 1. main index candidates (over-fetch to survive masking).
            # Adaptive: if heavy deletes-since-build invalidate more than
            # half the fetched window, double the fetch until every query
            # has min(k, live-snapshot-rows) valid candidates — so k results
            # are returned whenever >=k live points exist (reference
            # guarantees full results by re-searching the swapped index,
            # src/mutator/mod.rs:494-546). Common case stays at one fetch.
            fetch = min(max(2 * k, k + 8), snap_rows) if snap_rows else 0
            live = ~self._cand_invalid if snap_rows else np.zeros(0, bool)
            if mask_all is not None and snap_rows:
                live = live & mask_all[:snap_rows]
            live_snap = int(live.sum())
            need = min(k, live_snap)

            main_takes_mask = getattr(self, "_main_takes_mask", None)
            if main_takes_mask is None:
                import inspect

                sig = inspect.signature(self._main.search_batched_arrays)
                main_takes_mask = "allow_mask" in sig.parameters
                self._main_takes_mask = main_takes_mask

            def _fetch_candidates(f):
                kw = {}
                if mask_all is not None and main_takes_mask:
                    kw["allow_mask"] = mask_all[:snap_rows]
                ci, _ = self._main.search_batched_arrays(
                    queries, f, main_params, **kw)
                ci = np.asarray(ci, np.int64)
                in_range = (ci >= 0) & (ci < snap_rows)
                safe = np.clip(ci, 0, max(snap_rows - 1, 0))
                valid = in_range & ~self._cand_invalid[safe]
                if mask_all is not None:
                    valid &= mask_all[:snap_rows][safe]
                return ci, valid

            if fetch > 0:
                cand_i, cand_valid = _fetch_candidates(fetch)
                while (need > 0 and fetch < snap_rows
                       and cand_valid.sum(axis=1).min() < need):
                    fetch = min(fetch * 2, snap_rows)
                    # real (non-padding) candidates, deleted or not: stops
                    # growing when the main index hits its candidate
                    # ceiling — robust to searchers that pad their output
                    # to the requested width with -1 slots
                    prev_real = int((cand_i >= 0).sum(axis=1).max())
                    cand_i, cand_valid = _fetch_candidates(fetch)
                    if int((cand_i >= 0).sum(axis=1).max()) <= prev_real:
                        # the main index caps its candidate width (e.g.
                        # tree-AH's p*l_cap ceiling): doubling fetch can't
                        # widen the window, so stop re-searching and
                        # surface the lever instead of looping to
                        # fetch == snap_rows
                        if cand_valid.sum(axis=1).min() < need:
                            import warnings

                            warnings.warn(
                                "DynamicSearcher: the main index caps "
                                f"candidates at {cand_i.shape[1]} < the "
                                f"{need} live results some query needs "
                                "under heavy deletes; raise the searcher's"
                                " candidate ceiling (e.g. "
                                "num_leaves_to_search) or force_rebuild()",
                                RuntimeWarning, stacklevel=2)
                        break
            else:
                cand_i = np.zeros((b, 0), np.int64)
                cand_valid = np.zeros_like(cand_i, bool)
            f_pad = max(cand_i.shape[1], 1)
            if cand_i.shape[1] < f_pad:
                cand_i = np.concatenate(
                    [cand_i, np.full((b, f_pad - cand_i.shape[1]), -1,
                                     np.int64)], axis=1)
                cand_valid = np.concatenate(
                    [cand_valid, np.zeros((b, f_pad - cand_valid.shape[1]),
                                          bool)], axis=1)

            # 2. extra slab: delta adds + rows updated since build (shared
            # across queries; removed rows come back None -> stay invalid).
            # Device-cached between mutations: O(1) host work per search on
            # an unchanged index.
            import jax.numpy as jnp

            (extra_rows_dev, extra_ids_dev, extra_valid_dev,
             ids_np, valid_np) = self._extra_slab(d)
            e_pad = extra_rows_dev.shape[0]
            if mask_all is not None:
                # the allowlist changes per call: re-derive only the small
                # validity vector (e_pad bools), rows/ids stay cached
                mv = valid_np & mask_all[np.clip(ids_np, 0, total_rows - 1)]
                extra_valid_dev = jnp.asarray(mv)

            if snap_rows:
                snap_db = self._snapshot_ds.device()[0]
            else:
                snap_db = jnp.zeros((8, d), jnp.float32)
            k_eff = min(k, f_pad + e_pad)
            vals, idx = _dynamic_search_kernel(
                jnp.asarray(queries), snap_db,
                jnp.asarray(np.where(cand_valid, cand_i, -1).astype(np.int32)),
                extra_rows_dev, extra_ids_dev, extra_valid_dev,
                jnp.float32(eps), k=k_eff, measure=measure)
            out_i = np.full((b, k), -1, np.int64)
            out_d = np.full((b, k), np.inf, np.float32)
            out_i[:, :k_eff] = np.asarray(idx)
            out_d[:, :k_eff] = np.asarray(vals)
            return out_i, out_d

    def _measure_of_main(self):
        from scann_tpu.ops.distances import DistanceMeasure

        if self._distance_measure is not None:
            return self._distance_measure
        m = getattr(self._main, "distance_measure", None) \
            or getattr(self._main, "_measure", None)
        return m if m is not None else DistanceMeasure.SQUARED_L2
