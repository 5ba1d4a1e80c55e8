"""Sharding rules: parameter tree paths -> the dimension split over
"model" (counterpart of gill_tpu/parallel/partition.py).

Megatron tensor parallelism for the frozen OPT, gill_tpu's rules keyed by
gill_tpu's paths: attention q/k/v and fc1 split their output dimension
(column-parallel), the out-projection and fc2 their input dimension
(row-parallel), so a layer needs one reduce per attention block and one
per MLP block (models/opt.py) and activations stay split by heads between.
Stacked layer leaves carry a leading L axis, so a spec gains a leading
None. Everything else (the vision tower, adapters, norms, embeddings, the
row-parallel biases) is replicated. Batches split over "data".

A spec is a tuple as gill_tpu's PartitionSpec reads: () replicated,
(None, None, "model") the last of three dimensions split. gill_tpu's
`host_local_rows` + allgather is `collectives.gather_rows`.
"""

from __future__ import annotations

from typing import Any

import torch

MODEL = "model"
W8_REFUSAL = "mesh mode requires bf16 params (w8 kernel is single-chip)"
KV8_REFUSAL = ("int8 KV is a single-chip capacity mode; mesh serving "
               "shards the bf16 cache by heads")


def _opt_layer_spec(path_tail: str, leaf) -> tuple:
    """Spec for leaves under lm/layers/* (leading dim = L)."""
    two = leaf.ndim == 3  # (L, in, out) matrices; (L, dim) vectors
    if path_tail in ("attn.q.w", "attn.k.w", "attn.v.w", "fc1.w"):
        return (None, None, MODEL) if two else (None, MODEL)
    if path_tail in ("attn.q.b", "attn.k.b", "attn.v.b", "fc1.b"):
        return (None, MODEL)
    if path_tail in ("attn.o.w", "fc2.w"):
        return (None, MODEL, None)
    return ()  # norms, biases of row-parallel layers: replicated


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            isinstance(tree, tuple) and not tree):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(".".join(path), tree)


def param_pspecs(params: Any) -> Any:
    """Spec tree matching `params` (the GILL layout or any subtree), by
    gill_tpu's rules: a leaf under `layers.` of the LM (`lm.` or a bare
    OPT tree) takes `_opt_layer_spec`, every other leaf ()."""

    def rule(p, leaf):
        if not torch.is_tensor(leaf):
            return ()
        if ".layers." in p or p.startswith("layers."):
            idx = p.index("layers.") + len("layers.")
            tail = p[idx:]
            if p.startswith("lm.") or ".lm." in p or p.startswith("layers."):
                return _opt_layer_spec(tail, leaf)
            return ()
        return ()

    return _map_with_path(rule, params)


def _split_dim(spec) -> int:
    return spec.index(MODEL) if MODEL in spec else -1


def _refuse_w8(params) -> None:
    def check(p, leaf):
        if p.endswith(".w8") or p == "w8":
            raise ValueError(W8_REFUSAL)
        return leaf
    _map_with_path(check, params)


def shard_params(params: Any, mesh, device=None) -> Any:
    """This model rank's slice of every leaf the rules split (a fresh
    contiguous copy, so the full tree can be freed), the other leaves as
    they are; with `device`, every leaf is moved there, so a tree on the
    host puts only this rank's shard on its card. W8 leaves raise:
    gill_tpu's mesh refuses them."""
    _refuse_w8(params)
    specs = param_pspecs(params)
    tp, r = mesh.tp, mesh.tp_rank

    def cut(leaf, spec):
        dim = _split_dim(spec) if isinstance(spec, tuple) else -1
        if dim < 0 or tp == 1:
            return leaf if device is None else leaf.to(device)
        n = leaf.shape[dim]
        if n % tp:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} is "
                             f"not a multiple of tp {tp}")
        k = n // tp
        return leaf.narrow(dim, r * k, k).to(
            device or leaf.device, copy=True,
            memory_format=torch.contiguous_format)

    return _zip_map(cut, params, specs)


def gather_params(params: Any, mesh) -> Any:
    """The inverse of `shard_params`: every split leaf all-gathered over
    "model" back to its full size (the specs read paths and ranks only,
    so a shard has its full tree's specs)."""
    import torch.distributed as dist

    specs = param_pspecs(params)
    if mesh.model is None or mesh.tp == 1:
        return params

    def join(leaf, spec):
        dim = _split_dim(spec) if isinstance(spec, tuple) else -1
        if dim < 0:
            return leaf
        parts = [torch.empty_like(leaf) for _ in range(mesh.tp)]
        dist.all_gather(parts, leaf.contiguous(), group=mesh.model)
        return torch.cat(parts, dim=dim)

    return _zip_map(join, params, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree:
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    if not torch.is_tensor(tree):
        return tree
    return fn(tree, specs)


def local_heads(lm_params, head_dim: int) -> int:
    """Attention heads of a (possibly sharded) OPT tree: q's output width
    (a plain or a W8 weight) over the head dimension."""
    q = lm_params["layers"]["attn"]["q"]
    return q["w" if "w" in q else "w8"].shape[-1] // head_dim


def data_rows(n: int, mesh) -> slice:
    """This data rank's contiguous slice of n global rows (n a multiple
    of dp)."""
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not split over dp {mesh.dp}")
    k = n // mesh.dp
    return slice(mesh.dp_rank * k, (mesh.dp_rank + 1) * k)


def split_batch(batch: dict, mesh) -> dict:
    """This data rank's rows of every leaf of a global batch (gill_tpu's
    `batch_sharding`: the leading dimension split over "data")."""
    out = {}
    for k, v in batch.items():
        out[k] = v[data_rows(len(v), mesh)]
    return out


def replicated(tree: Any, mesh) -> Any:
    """Checks gill_tpu's `replicated` placement: every rank builds
    replicated state itself (the same seed, the same calls), and this
    raises unless every rank holds `tree` bit for bit (one digest of its
    leaves, compared over the whole world). Returns the tree."""
    import hashlib

    from gill_tpu_torch.nn.core import tree_leaves
    from gill_tpu_torch.parallel.collectives import all_equal

    if mesh is None or mesh.dp * mesh.tp == 1:
        return tree
    h = hashlib.sha1()
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            h.update(leaf.detach().reshape(-1).contiguous()
                     .view(torch.uint8).cpu().numpy().tobytes())
    digest = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
    if not all_equal(digest):
        raise RuntimeError("replicated state differs across ranks: every "
                           "rank must build it from the same inputs")
    return tree
