"""ZeRO-sharded bucketed weight update, ``GEOMX_ZERO=1`` (port of
geomx_tpu/train/zero.py).

The replicated update has every replica hold the whole optimizer state
and apply the same update.  The sharded form

    allreduce(g); update(all)  ==  reduce_scatter(g); update(my 1/W
                                   shard); all_gather(params)

costs the same summed wire bytes, and the optimizer and error-feedback
state drop to about ``1/W`` a replica.  The unit of sharding is the
fused fp32 bucket of the dc tier (``compression/bucketing.py``): worker
``w`` owns the contiguous slice ``[w * n / W, (w + 1) * n / W)`` of
every bucket.

- worker tier: ``psum_scatter`` of the flat buckets over the worker axis
  replaces the worker mean; each replica keeps the party mean of its
  shard;
- dc tier: the compressor runs on each shard (``allreduce_shards``);
  its residuals live shard-local;
- update: the optimizer runs on the shard list (its state allocated
  shard-shaped by ``Trainer.init_state``), through the fused kernels of
  ``ops/optim.py`` when a fused spec is bound;
- one ``all_gather`` a bucket rebuilds the replicated params.

Element-wise optimizers (SGD, momentum, Adam) give the replicated
update's values; an optimizer that couples a whole tensor (global-norm
clipping) would see per-shard statistics.

In the port every replica lives in one tensor with the leading ``[P,
W]`` axes, so a shard tensor is ``[P, W, n / W]`` and slot ``(p, w)``
holds worker ``w``'s shard: the content differs across the worker axis
by design.  The worker index is the slot's own, so the ops take no
``widx``.  ``zero_checkpoint_meta``, the ``_fit_*`` helpers and
``reshard_zero_state`` are the host-side layout of a sharded
checkpoint, on numpy arrays (``Trainer.save_checkpoint``/
``load_checkpoint``); ``host_zero_state``/``place_zero_state`` that of
a returning party's catch-up payload (``Trainer.catchup_payload``/
``admit_party``).  ``wire_accounting`` gives the ZeRO step's static
bytes to the telemetry probes, and the Trainer publishes the
``geomx_zero_*`` gauges from the plan (``Trainer._publish_telemetry``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from geomx_tpu_torch.compression.bucketing import (_LANE_PAD,
                                                   BucketedCompressor)
from geomx_tpu_torch.parallel.collectives import all_gather, psum_scatter
from geomx_tpu_torch.topology import WORKER_AXIS
from geomx_tpu_torch.tree import leaf_names


def slice_worker_shards(flat: torch.Tensor, W: int) -> torch.Tensor:
    """Each slot's own shard of a replicated ``[P, W, W * s]`` flat
    tensor: slot ``(p, w)`` gets ``flat[p, w, w * s:(w + 1) * s]``.  A
    new contiguous ``[P, W, s]`` tensor."""
    P = flat.shape[0]
    s = flat.shape[-1] // W
    ar = torch.arange(W, device=flat.device)
    return flat.reshape(P, W, W, s)[:, ar, ar]


class ZeroPlan:
    """The sharded-update plan over the worker axis.

    Built by ``train.step.build_train_step`` (or ``Trainer``) when
    ``config.zero`` is set and bound into the sync algorithm
    (``SyncAlgorithm.bind_zero``).  Holds W and the lane alignment; the
    bucket layout stays the :class:`BucketedCompressor`'s, so the ZeRO
    path slices the coordinates the replicated path fuses.
    """

    def __init__(self, workers_per_party: int, lane: int = _LANE_PAD):
        if workers_per_party < 1:
            raise ValueError("workers_per_party must be >= 1")
        self.W = int(workers_per_party)
        self.lane = int(lane)
        self.bucketed: "BucketedCompressor | None" = None  # bind_compressor
        # set by build_train_step under GEOMX_FUSED_OPTIM: the spec routes
        # apply_shard_update through the fused kernels (ops/optim.py)
        self.fused_spec = None

    @property
    def pad_to(self) -> int:
        """Bucket padding that makes every shard lane-aligned: each of
        the W shards a multiple of the lane width (and of the 2-bit
        packer's 16-code word)."""
        return self.lane * self.W

    # ---- wiring -------------------------------------------------------------

    def bind_compressor(self, dc_compressor) -> BucketedCompressor:
        """Check the dc-tier compressor stack for the ZeRO path and
        re-align its bucket padding so the buckets split into W
        lane-aligned shards (clearing the layouts cached under the old
        padding).  Returns the underlying :class:`BucketedCompressor`."""
        from geomx_tpu_torch.sync.pipeline import PipelinedCompressor
        comp = dc_compressor
        if isinstance(comp, PipelinedCompressor):
            comp = comp.inner
        if not isinstance(comp, BucketedCompressor):
            raise ValueError(
                "GEOMX_ZERO requires the bucketed dc-tier engine: the "
                "shard unit is the fused flat bucket.  Re-enable "
                "bucketing (GEOMX_BUCKET_BYTES > 0) and use a dc "
                f"compressor it can wrap (got "
                f"{getattr(dc_compressor, 'name', type(dc_compressor).__name__)!r})")
        if comp.pad_to % self.pad_to:
            comp.pad_to = self.pad_to
            comp._bucketers.clear()  # layouts cached under the old pad
        self.bucketed = comp
        return comp

    # ---- the shard ops on [P, W, ...] tensors -------------------------------

    def shard_len(self, bucket_size: int) -> int:
        return bucket_size // self.W

    def scatter_bucket(self, bucket: torch.Tensor,
                       axis_name: str = WORKER_AXIS) -> torch.Tensor:
        """Worker-tier mean of one flat ``[P, W, n]`` bucket as shards:
        ``psum_scatter`` and a divide by W; slot ``(p, w)`` keeps the
        party mean of its contiguous shard."""
        if self.W == 1:
            return bucket
        return psum_scatter(bucket, axis_name) / self.W

    def slice_shard(self, bucket: torch.Tensor) -> torch.Tensor:
        """Each worker's shard of a replicated flat bucket (params, the
        stale copy): a slice, no collective."""
        if self.W == 1:
            return bucket
        return slice_worker_shards(bucket, self.W)

    def gather_bucket(self, shard: torch.Tensor,
                      axis_name: str = WORKER_AXIS) -> torch.Tensor:
        """The full flat bucket from the W worker shards (a broadcast
        view over the workers)."""
        if self.W == 1:
            return shard
        return all_gather(shard, axis_name, tiled=True)

    def tree_shards(self, tree: dict, bk) -> List[torch.Tensor]:
        """A replicated tree flattened onto the bucket layout, each
        worker's shard of every bucket (the param and stale-copy side of
        the sharded update)."""
        leaves = [tree[k] for k in leaf_names(tree)]
        return [self.slice_shard(b) for b in bk.flatten(leaves)]

    def apply_shard_update(self, tx, shard_g: List[torch.Tensor],
                           params: dict, opt_state,
                           axis_name: str = WORKER_AXIS) -> tuple:
        """The shard-local optimizer step and the param rebuild: slice
        each worker's param shards, run the optimizer on (shard gradient,
        shard param) pairs, all_gather the new shards into full buckets
        and unflatten.  The one shard-update path of the train step and
        the pipeline drain.  Returns ``(params, opt_state)``."""
        names = leaf_names(params)
        leaves = [params[k] for k in names]
        bk = self.bucketed.zero_bucketer(leaves)
        p_shards = [self.slice_shard(b) for b in bk.flatten(leaves)]
        if self.fused_spec is not None:
            # the fused kernels take any [*B, n] rows: the shards go
            # through as they are, one launch a bucket over P*W rows
            from geomx_tpu_torch.ops.optim import fused_apply
            new_shards, opt_state = fused_apply(self.fused_spec, p_shards,
                                                shard_g, opt_state)
        else:
            new_shards, opt_state = tx.update(list(shard_g), opt_state,
                                              p_shards)
        full = [self.gather_bucket(sh, axis_name) for sh in new_shards]
        return dict(zip(names, bk.unflatten(full))), opt_state

    def wire_accounting(self, params: dict) -> dict:
        """Static wire bytes a replica of the ZeRO step (floats, resolved
        when the step is built): the psum_scatter sends ``(W-1)/W`` of
        each bucket, the params all_gather sends this replica's shard to
        W-1 peers, and the dc tier carries the inner compressor's
        payload for one shard."""
        bucketed = self.bucketed
        leaves = [params[k] for k in leaf_names(params)]
        if not leaves or bucketed is None:
            return {}
        bk = bucketed.zero_bucketer(leaves)
        padded = float(sum(bk.bucket_sizes))
        frac = (self.W - 1) / self.W
        return {
            "zero_scatter_bytes": 4.0 * padded * frac,
            "zero_gather_bytes": 4.0 * padded * frac,
            "dc_wire_bytes": float(
                bucketed.shard_wire_bytes(params, self.W)),
        }

    # ---- layout -------------------------------------------------------------

    def shard_example(self, params: dict,
                      bucketed: BucketedCompressor) -> List[torch.Tensor]:
        """Zero ``[P, W, n / W]`` shards matching the sharded update's
        operands: what ``tx.init`` sees, so the optimizer state is
        allocated shard-shaped."""
        leaves = [params[k] for k in leaf_names(params)]
        bk = bucketed.zero_bucketer(leaves)
        lead = tuple(leaves[0].shape[:2])
        return [torch.zeros(lead + (self.shard_len(n),), dtype=torch.float32,
                            device=leaves[0].device)
                for n in bk.bucket_sizes]


# ---------------------------------------------------------------------------
# host-side layout of a sharded checkpoint (numpy)
# ---------------------------------------------------------------------------

def zero_checkpoint_meta(plan: "ZeroPlan | None", topology) -> dict:
    """The checkpoint meta block that makes sharded state restorable:
    whether the state is sharded and the worker count it was sharded
    over."""
    return {
        "zero": plan is not None,
        "num_parties": int(topology.num_parties),
        "workers_per_party": int(topology.workers_per_party),
    }


def _fit_flat(flat: np.ndarray, n_new: int) -> np.ndarray:
    """Truncate or zero-extend a full padded flat bucket to a new padded
    length.  Safe both ways: positions past the bucket's true fill are
    lane padding, zero in every shard buffer."""
    flat = np.asarray(flat).reshape(-1)
    if flat.size >= n_new:
        return np.ascontiguousarray(flat[:n_new])
    return np.concatenate(
        [flat, np.zeros((n_new - flat.size,), flat.dtype)])


def _fit_shard_leaf(old: np.ndarray, t_shape) -> np.ndarray:
    """One shard leaf ``[P_old, W_old, ...]`` -> ``[P, W, ...]``: party
    0's worker shards concatenated into the full padded bucket, re-fit
    to the new padded length, split over the new worker count and
    broadcast over the parties (shard content is identical across
    parties, distinct across workers)."""
    old = np.asarray(old)
    if old.ndim == 2:  # a per-slot scalar (an optimizer count): replicated
        return np.broadcast_to(old[0, 0], t_shape).copy()
    full = old[0].reshape(-1)  # W_old contiguous shards == the bucket
    n_new = 1
    for d in t_shape[1:]:
        n_new *= d
    return np.broadcast_to(
        _fit_flat(full, n_new).reshape(t_shape[1:])[None],
        t_shape).copy()


def _fit_replicated_leaf(old: np.ndarray, t_shape) -> np.ndarray:
    """A replicated leaf ``[P_old, W_old, *r]`` -> ``[P, W, *r]``: copy
    ``(0, 0)`` and broadcast."""
    old = np.asarray(old)
    v = old[0, 0] if old.ndim >= 2 else old
    if v.shape != tuple(t_shape[2:]):
        raise ValueError(
            f"replicated checkpoint leaf {old.shape} does not fit the "
            f"target slot {tuple(t_shape)} — the checkpoint was saved "
            "from a different model/optimizer configuration")
    return np.broadcast_to(v[None, None], t_shape).copy()


def _under_dc_comp(path) -> bool:
    """Shard-bearing sync state is recognized by its dict key: the ZeRO
    contract keeps shard-shaped dc-tier compressor state under the
    ``"dc_comp"`` key of the sync state (FSA, MixedSync and the pipeline
    all do), as in the JAX package."""
    return "dc_comp" in path


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over the array leaves of ``tree``
    (tensors or numpy arrays), the dict keys on the way in ``path``;
    other leaves (host scalars) come from the last tree of ``rest`` if
    any, else from ``tree``."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("state trees have different keys")
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError("state trees have different lengths")
        return type(tree)(_map_with_path(fn, *xs, path=path)
                          for xs in zip(tree, *rest))
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(path, tree, *rest)
    return rest[-1] if rest else tree


def _state_fields(state) -> dict:
    """A ``TrainState`` or the dict a checkpoint stores it as."""
    if isinstance(state, dict):
        return state
    return {f: getattr(state, f) for f in
            ("step", "params", "opt_state", "model_state", "sync_state")}


def host_zero_state(state):
    """One host-side copy of a ZeRO ``TrainState`` for catch-up:
    replicated fields collapse to copy ``(0, 0)`` as ``unreplicate_tree``
    does, but the shard-bearing fields (the optimizer state and every
    ``dc_comp`` subtree) keep party 0's whole worker axis — copying
    ``(0, 0)`` there would drop workers 1..W-1's shards.  Numpy leaves;
    host scalars as stored."""
    from geomx_tpu_torch.train.state import TrainState
    fields = _state_fields(state)

    def host(x):
        return x.detach().numpy(force=True).copy() \
            if isinstance(x, torch.Tensor) else np.asarray(x)

    def rep(path, x):
        return host(x)[0, 0]

    def shard(path, x):
        return host(x)[0]

    def sync(path, x):
        return shard(path, x) if _under_dc_comp(path) else rep(path, x)

    return TrainState(
        step=fields["step"],
        params=_map_with_path(rep, fields["params"]),
        opt_state=_map_with_path(shard, fields["opt_state"]),
        model_state=_map_with_path(rep, fields["model_state"]),
        sync_state=_map_with_path(sync, fields["sync_state"]))


def place_zero_state(host_state, topology, device):
    """Inverse of :func:`host_zero_state` (a ``TrainState`` or the dict
    a catch-up payload unpacks to): replicated fields broadcast over both
    replica axes, shard-bearing fields (leading ``[W, ...]``) over the
    parties only, so every worker slot gets back exactly its own shard.
    Tensors on ``device``."""
    from geomx_tpu_torch.train.state import TrainState
    fields = _state_fields(host_state)
    P, W = topology.num_parties, topology.workers_per_party

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    def rep(path, x):
        x = np.asarray(x)
        return put(np.broadcast_to(x[None, None], (P, W) + x.shape))

    def shard(path, x):
        x = np.asarray(x)
        if x.shape[0] != W:
            raise ValueError(
                f"sharded state leaf carries {x.shape[0]} worker shards "
                f"but this topology has {W} workers per party — re-shard "
                "the checkpoint (Trainer.load_checkpoint) instead of "
                "installing it directly")
        return put(np.broadcast_to(x[None], (P,) + x.shape))

    def sync(path, x):
        return shard(path, x) if _under_dc_comp(path) else rep(path, x)

    return TrainState(
        step=fields["step"],
        params=_map_with_path(rep, fields["params"]),
        opt_state=_map_with_path(shard, fields["opt_state"]),
        model_state=_map_with_path(rep, fields["model_state"]),
        sync_state=_map_with_path(sync, fields["sync_state"]))


def reshard_zero_state(host_state, template):
    """Re-shard a host-side ZeRO state (numpy leaves with ``[P_old,
    W_old, ...]`` replica axes, as a checkpoint stores it) onto
    ``template``'s topology, devices and dtypes.

    - ``params`` / ``model_state``: replicated — copy ``(0, 0)``;
    - ``opt_state``: every array leaf is a flat bucket shard (or a
      per-slot scalar) — the old worker shards gathered into the full
      padded bucket and re-split for the new worker count;
    - ``sync_state``: leaves under any ``"dc_comp"`` key (the residuals,
      the pipelined in-flight buffers) are shard-shaped and re-split
      like the optimizer's; everything else is replicated.

    Host scalars (step counts, Adam's count) are the checkpoint's.
    Shapes come pairwise from ``template`` (same config, new topology);
    a structure mismatch raises ``ValueError``."""
    from geomx_tpu_torch.train.state import TrainState
    host = _state_fields(host_state)

    def place(arr, like):
        return torch.as_tensor(arr, device=like.device).to(like.dtype)

    def conv_rep(path, t, o):
        return place(_fit_replicated_leaf(o, tuple(t.shape)), t)

    def conv_shard(path, t, o):
        return place(_fit_shard_leaf(o, tuple(t.shape)), t)

    def conv_sync(path, t, o):
        return conv_shard(path, t, o) if _under_dc_comp(path) \
            else conv_rep(path, t, o)

    try:
        return TrainState(
            step=host["step"],
            params=_map_with_path(conv_rep, template.params,
                                  host["params"]),
            opt_state=_map_with_path(conv_shard, template.opt_state,
                                     host["opt_state"]),
            model_state=_map_with_path(conv_rep, template.model_state,
                                       host["model_state"]),
            sync_state=_map_with_path(conv_sync, template.sync_state,
                                      host["sync_state"]))
    except ValueError as e:
        raise ValueError(
            "cannot re-shard checkpoint onto this trainer: the state "
            "trees disagree beyond the worker count (different model, "
            f"optimizer, or sync configuration?) — {e}") from e
