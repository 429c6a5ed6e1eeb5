"""Index serialization: save/load trained artifacts.

The reference never serializes trained artifacts (codebooks, trees,
quantizers are not Serialize — SURVEY §5 flags this as a capability gap;
only configs round-trip). Since BASELINE measures build wall-clock, loading
a prebuilt index is a first-class capability here.

Format: one ``.npz`` per index holding every array + a JSON header with the
config and index kind. Loaders reconstruct the searcher without retraining.
"""

from __future__ import annotations

import dataclasses
import json
import numpy as np

from scann_tpu.data.dataset import DenseDataset
from scann_tpu.errors import ScannError

_FORMAT_VERSION = 1


def _ah_cfg_dict(cfg) -> dict:
    """AsymmetricHasherConfig -> JSON-safe dict (enum measure -> value)."""
    d = dataclasses.asdict(cfg)
    d["distance_measure"] = cfg.distance_measure.value
    return d


def _restore_avq(cb, threshold) -> None:
    """Re-derive the anisotropic eta on a deserialized codebook so future
    re-encodes (mutations) stay score-aware (hashes/avq.py)."""
    if threshold is not None:
        from scann_tpu.hashes.avq import anisotropic_eta

        cb.config.anisotropic_threshold = float(threshold)
        cb.eta = anisotropic_eta(float(threshold), cb.dimensionality)


def _ah_cfg_load(d: dict):
    from scann_tpu.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu.ops.distances import DistanceMeasure

    d = dict(d)
    if "distance_measure" in d:
        d["distance_measure"] = DistanceMeasure(d["distance_measure"])
    return AsymmetricHasherConfig(**d)


def _cfg_json(obj) -> str:
    if hasattr(obj, "to_json"):
        return obj.to_json()
    return json.dumps(dataclasses.asdict(obj), default=str)


# ---------------------------------------------------------------------------
# per-searcher serializers
# ---------------------------------------------------------------------------


def save_index(path: str, searcher) -> None:
    """Save a trained searcher (BruteForce / ScalarQuantized / Partitioned /
    AsymmetricHasher / TreeXHybrid / Scann facade) to ``path`` (.npz)."""
    from scann_tpu.hashes.hasher import AsymmetricHasher
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.models.partitioned import PartitionedSearcher
    from scann_tpu.models.scalar_quantized import ScalarQuantizedBruteForceSearcher
    from scann_tpu.models.scann import Scann
    from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher

    if isinstance(searcher, Scann):
        inner = searcher.impl
        arrays, meta = _serialize(inner)
        meta["scann_config"] = searcher.config.to_dict()
        meta["facade"] = True
    else:
        arrays, meta = _serialize(searcher)
        meta["facade"] = False
    meta["format_version"] = _FORMAT_VERSION
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def _serialize(searcher):
    from scann_tpu.hashes.hasher import AsymmetricHasher
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.models.partitioned import PartitionedSearcher
    from scann_tpu.models.scalar_quantized import ScalarQuantizedBruteForceSearcher
    from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher

    if isinstance(searcher, BruteForceSearcher):
        return (
            {"data": searcher.dataset.numpy()},
            {"kind": "brute_force", "measure": searcher.distance_measure.value},
        )
    if isinstance(searcher, ScalarQuantizedBruteForceSearcher):
        q = searcher.quantized_dataset
        meta = {"kind": "scalar_quantized",
                "measure": searcher._measure.value,
                "storage": searcher._config.storage}
        if hasattr(q, "codes"):
            meta.update(scale=float(q.quantizer.scale),
                        min_value=float(q.quantizer.min_value),
                        bits=q.quantizer.config.bits)
            return {"codes": q.codes}, meta
        return {"data": q.to_f32()}, meta
    if isinstance(searcher, PartitionedSearcher):
        tp = searcher.partitioner
        return (
            {"data": searcher._dataset.numpy(),
             "centers": tp.centers,
             "tokens": tp.tokenization.tokens,
             "csr_offsets": tp.tokenization.offsets,
             "csr_points": tp.tokenization.point_indices},
            {"kind": "partitioned", "measure": searcher._measure.value,
             "p": searcher._p_default},
        )
    if isinstance(searcher, AsymmetricHasher):
        arrays = {"codes": searcher.codes,
                  "codebook": searcher.codebook.centroids}
        if searcher._dataset is not None:
            arrays["data"] = searcher._dataset.numpy()
        return arrays, {"kind": "hashed", "dim": searcher._dim,
                        "config": _ah_cfg_dict(searcher.config)}
    if isinstance(searcher, TreeXHybridSearcher):
        return (
            {"data": searcher._dataset.numpy(),
             "centers": searcher.partitioner.centers,
             "tokens": searcher.partitioner.tokenization.tokens,
             "csr_offsets": searcher.partitioner.tokenization.offsets,
             "csr_points": searcher.partitioner.tokenization.point_indices,
             "codes": searcher.codes,
             "codebook": searcher.codebook.centroids},
            {"kind": "tree_ah",
             # codes are per-ASSIGNMENT rows in CSR order (spilling-correct
             # residuals); absent flag = legacy per-point rows
             "assignment_codes": True,
             "num_partitions": searcher.config.num_partitions,
             "partitions_to_search": searcher.config.partitions_to_search,
             "use_residuals": searcher.config.use_residuals,
             "pre_reorder_multiplier": searcher.config.pre_reorder_multiplier,
             "hash_config": _ah_cfg_dict(searcher.config.hash_config),
             "rerank_dtype": searcher.config.rerank_dtype,
             "rerank_layout": searcher.config.rerank_layout,
             "measure": searcher.config.distance_measure.value},
        )
    from scann_tpu.models.block_sweep import BlockSweepSearcher

    if isinstance(searcher, BlockSweepSearcher):
        cfg = searcher._config
        return (
            {"data": searcher.dataset.numpy()},
            {"kind": "block_sweep", "measure": cfg.distance_measure.value,
             "pre_reorder_k": cfg.pre_reorder_k, "block_r": cfg.block_r,
             "tile_n": cfg.tile_n, "max_batch": cfg.max_batch,
             "top2": cfg.top2, "shuffle": cfg.shuffle,
             "rerank_dtype": cfg.rerank_dtype,
             "sweep_dtype": cfg.sweep_dtype},
        )
    raise ScannError.unimplemented(f"cannot serialize {type(searcher).__name__}")


def _load_tokenization(arrays):
    from scann_tpu.partitioning.partitioner import DatabaseTokenization

    if "csr_offsets" in arrays:  # preserves spilling multi-assignments
        return DatabaseTokenization.from_csr(
            arrays["tokens"], arrays["csr_offsets"], arrays["csr_points"])
    return DatabaseTokenization(arrays["tokens"], len(arrays["centers"]))


def load_index(path: str):
    """Load a searcher saved with :func:`save_index` (no retraining)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ScannError.failed_precondition(
                f"unsupported index format {meta.get('format_version')}")
        if "sharded_kind" in meta:
            raise ScannError.failed_precondition(
                "this file is a sharded serving layout (kind "
                f"{meta['sharded_kind']!r}); load it with "
                "io.load_sharded_layout / <Sharded*Searcher>.load_layout")
        if "kind" not in meta:
            raise ScannError.failed_precondition(
                "not a save_index file: missing index kind")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return _deserialize_index(meta, arrays)


def _deserialize_index(meta: dict, arrays: dict):
    from scann_tpu.hashes.codebook import Codebook, CodebookConfig
    from scann_tpu.hashes.hasher import AsymmetricHasher, AsymmetricHasherConfig
    from scann_tpu.models.brute_force import BruteForceSearcher
    from scann_tpu.models.partitioned import PartitionedSearcher
    from scann_tpu.models.scalar_quantized import (
        ScalarQuantizedBruteForceSearcher,
        ScalarQuantizedConfig,
    )
    from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig, TreeXHybridSearcher
    from scann_tpu.ops.distances import DistanceMeasure
    from scann_tpu.partitioning.partitioner import DatabaseTokenization
    from scann_tpu.partitioning.tree_partitioner import (
        TreePartitioner,
        TreePartitionerConfig,
    )
    from scann_tpu.quantization.scalar import (
        QuantizedDataset,
        ScalarQuantizer,
        ScalarQuantizerConfig,
    )

    kind = meta["kind"]
    if kind == "brute_force":
        return BruteForceSearcher(DenseDataset(arrays["data"]),
                                  DistanceMeasure(meta["measure"]))
    if kind == "block_sweep":
        from scann_tpu.models.block_sweep import (
            BlockSweepConfig,
            BlockSweepSearcher,
        )

        return BlockSweepSearcher(DenseDataset(arrays["data"]), BlockSweepConfig(
            distance_measure=DistanceMeasure(meta["measure"]),
            pre_reorder_k=int(meta["pre_reorder_k"]),
            block_r=int(meta["block_r"]), tile_n=int(meta["tile_n"]),
            max_batch=int(meta["max_batch"]), top2=bool(meta["top2"]),
            shuffle=bool(meta.get("shuffle", True)),
            rerank_dtype=str(meta.get("rerank_dtype", "float32")),
            sweep_dtype=str(meta.get("sweep_dtype", "bfloat16"))))
    if kind == "scalar_quantized":
        if "codes" in arrays:
            quant = ScalarQuantizer(ScalarQuantizerConfig(bits=meta["bits"]))
            quant.min_value = meta["min_value"]
            quant.scale = meta["scale"]
            quant.max_value = meta["min_value"] + meta["scale"] * quant.num_levels
            quant.inv_scale = 1.0 / meta["scale"] if meta["scale"] else 1.0
            qd = QuantizedDataset(arrays["codes"], quant)
            return ScalarQuantizedBruteForceSearcher.from_quantized(
                qd, DistanceMeasure(meta["measure"]))
        return ScalarQuantizedBruteForceSearcher(
            DenseDataset(arrays["data"]),
            ScalarQuantizedConfig(distance_measure=DistanceMeasure(meta["measure"]),
                                  storage=meta["storage"]))
    if kind == "partitioned":
        tp = TreePartitioner(TreePartitionerConfig(
            num_partitions=len(arrays["centers"]),
            distance_measure=DistanceMeasure(meta["measure"])))
        tp.centers = arrays["centers"]
        tp.tokenization = _load_tokenization(arrays)
        return PartitionedSearcher(
            DenseDataset(arrays["data"]), partitioner=tp,
            num_partitions_to_search=meta["p"],
            distance_measure=DistanceMeasure(meta["measure"]))
    if kind == "hashed":
        cfgd = dict(meta["config"])
        h = AsymmetricHasher(_ah_cfg_load(cfgd))
        cb = Codebook(CodebookConfig(num_codes=arrays["codebook"].shape[1],
                                     num_subspaces=arrays["codebook"].shape[0]))
        cb.centroids = arrays["codebook"]
        cb.dimensionality = arrays["codebook"].shape[0] * arrays["codebook"].shape[2]
        cb.dims_per_subspace = arrays["codebook"].shape[2]
        _restore_avq(cb, cfgd.get("anisotropic_threshold"))
        h.codebook = cb
        h.codes = arrays["codes"]
        h._n = len(arrays["codes"])
        h._dim = meta["dim"]
        if "data" in arrays:
            h._dataset = DenseDataset(arrays["data"])
        h._codes_dev = None
        h._codes_t_dev = None
        return h
    if kind == "tree_ah":
        hc = _ah_cfg_load(meta["hash_config"])
        cfg = TreeXHybridConfig(
            num_partitions=meta["num_partitions"],
            partitions_to_search=meta["partitions_to_search"],
            hash_config=hc,
            use_residuals=meta["use_residuals"],
            pre_reorder_multiplier=meta["pre_reorder_multiplier"],
            distance_measure=DistanceMeasure(meta["measure"]),
            rerank_dtype=meta.get("rerank_dtype", "float32"),
            # (files may carry the retired kernel-shape keys score_l_tile,
            # group_q_cap and pack_codes: the slab layout now follows the
            # platform's leaf scorer, so they are ignored)
            # auto (None) resolves to "csr" only when results are
            # bit-identical to "id", so legacy files may take the faster
            # layout safely; an explicit save value round-trips
            rerank_layout=meta.get("rerank_layout"),
        )
        s = TreeXHybridSearcher(cfg)
        s._dataset = DenseDataset(arrays["data"])
        tp = TreePartitioner(TreePartitionerConfig(num_partitions=meta["num_partitions"]))
        tp.centers = arrays["centers"]
        tp.tokenization = _load_tokenization(arrays)
        s.partitioner = tp
        cb = Codebook(CodebookConfig(num_codes=arrays["codebook"].shape[1],
                                     num_subspaces=arrays["codebook"].shape[0]))
        cb.centroids = arrays["codebook"]
        cb.dimensionality = arrays["codebook"].shape[0] * arrays["codebook"].shape[2]
        cb.dims_per_subspace = arrays["codebook"].shape[2]
        _restore_avq(cb, getattr(hc, "anisotropic_threshold", None))
        s.codebook = cb
        s.codes = arrays["codes"]
        if not meta.get("assignment_codes", False):
            # legacy per-point rows -> per-assignment CSR rows (legacy files
            # never spilled, so every CSR row's partition is the primary
            # token and the residual codes transfer unchanged)
            s.codes = s.codes[tp.tokenization.point_indices]
        return s
    raise ScannError.unimplemented(f"unknown index kind {kind!r}")


# ---------------------------------------------------------------------------
# sharded serving-layout warm start
# ---------------------------------------------------------------------------


def _dtype_safe_store(arr: np.ndarray):
    """(storable array, dtype tag) — npz cannot hold extension dtypes
    (bfloat16/fp8), so they travel as same-width unsigned views."""
    name = str(arr.dtype)
    if arr.dtype in (np.float32, np.float64, np.int8, np.uint8, np.int16,
                     np.int32, np.int64, np.uint16, np.uint32, np.uint64,
                     np.float16, np.bool_):
        return arr, name
    view = np.uint16 if arr.dtype.itemsize == 2 else np.uint8
    return arr.view(view), name


def _dtype_safe_load(arr: np.ndarray, name: str) -> np.ndarray:
    if str(arr.dtype) == name:
        return arr
    import ml_dtypes  # noqa: F401 - registers bfloat16/fp8 numpy dtypes

    return arr.view(np.dtype(name))


def save_sharded_layout(path: str, sharded) -> None:
    """Persist a sharded wrapper's per-shard serving layout + the inner
    searcher's trained artifacts to ONE .npz, so a serving restart skips
    the host re-layout (tree: per-partition re-shard + rerank re-encode;
    sweep: augment + shuffle + rerank encode). The device upload itself is
    unavoidable either way. Supports ShardedTreeXHybridSearcher and
    ShardedBlockSweepSearcher."""
    from scann_tpu.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
        _compute_sweep_shard_layout,
        _compute_tree_shard_layout,
    )

    extra_meta = {}
    if isinstance(sharded, ShardedTreeXHybridSearcher):
        kind = "tree_ah"
        layout = _compute_tree_shard_layout(sharded._inner,
                                            sharded.mesh.shape["db"])
        keys = tuple(k for k in ("codes", "perm", "db", "sizes", "offs",
                                 "tok") if layout.get(k) is not None)
        extra_meta["layout_l_cap"] = int(layout["l_cap"])
        # residual-anchored int8 codec params (None for f32/bf16)
        extra_meta["layout_dequant"] = layout.get("dequant")
    elif isinstance(sharded, ShardedBlockSweepSearcher):
        kind = "block_sweep"
        layout = _compute_sweep_shard_layout(sharded._inner,
                                             sharded.mesh.shape["db"])
        keys = tuple(k for k in ("aug", "rdb", "inv", "aug_scales")
                     if layout.get(k) is not None)
        extra_meta["layout_blk"] = int(layout["blk"])
        extra_meta["layout_aug_sn"] = float(layout["aug_sn"])
        extra_meta["layout_dequant"] = layout["dequant"]
        extra_meta["layout_has_inv"] = layout["inv"] is not None
    else:
        raise ScannError.unimplemented(
            "save_sharded_layout supports ShardedTreeXHybridSearcher and "
            "ShardedBlockSweepSearcher")
    inner_arrays, inner_meta = _serialize(sharded._inner)
    dtypes = {}
    arrays = {f"inner__{k}": v for k, v in inner_arrays.items()}
    for k in keys:
        arrays[f"layout__{k}"], dtypes[k] = _dtype_safe_store(layout[k])
    meta = {
        "format_version": _FORMAT_VERSION,
        "sharded_kind": kind,
        "inner": inner_meta,
        "layout_n_sh": int(layout["n_sh"]),
        "layout_dtypes": dtypes,
        **extra_meta,
    }
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_sharded_layout(path: str, cls=None, mesh=None):
    """Restore a wrapper saved with :func:`save_sharded_layout` — the
    per-shard slabs go straight from disk to the sharded device layout."""
    from scann_tpu.parallel.mesh import make_mesh
    from scann_tpu.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
    )

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ScannError.failed_precondition(
                f"unsupported layout format {meta.get('format_version')}")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    kind = meta.get("sharded_kind")
    if cls is None:
        cls = {"tree_ah": ShardedTreeXHybridSearcher,
               "block_sweep": ShardedBlockSweepSearcher}.get(kind)
        if cls is None:
            raise ScannError.unimplemented(
                f"unknown sharded layout kind {kind!r}")

    inner = _deserialize_index(
        meta["inner"],
        {k[len("inner__"):]: v for k, v in arrays.items()
         if k.startswith("inner__")})
    dtypes = meta.get("layout_dtypes", {})
    layout = {}
    for k, v in arrays.items():
        if k.startswith("layout__"):
            name = k[len("layout__"):]
            layout[name] = _dtype_safe_load(v, dtypes.get(name, str(v.dtype)))
    layout["n_sh"] = meta["layout_n_sh"]
    mesh = mesh or make_mesh(axis_names=("db",))
    if kind == "tree_ah":
        layout["l_cap"] = meta["layout_l_cap"]
        layout["dequant"] = meta.get("layout_dequant")
        return cls(inner, mesh, layout=layout)
    layout["blk"] = meta["layout_blk"]
    layout["aug_sn"] = meta["layout_aug_sn"]
    layout["dequant"] = meta["layout_dequant"]
    if not meta.get("layout_has_inv", False):
        layout["inv"] = None
    return cls(inner, mesh, layout=layout)
