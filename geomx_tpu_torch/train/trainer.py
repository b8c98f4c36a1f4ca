"""High-level Trainer (port of the fit path of geomx_tpu/train/trainer.py).

Wires model + optimizer + sync algorithm + topology into a fit loop with
per-iteration records, as the JAX ``Trainer.init_state``/``make_loader``/
``fit``/``evaluate`` do.  The model is a template ``nn.Module``: the
weights live in the ``TrainState`` with ``[P, W]`` replica axes, and
each replica's forward substitutes its own slice
(``torch.func.functional_call``).

An sp-aware model (``SeqClassifier(sp_mode="ring")``) takes each
replica's sequence as ``topology.sp_degree`` chunks (``train/step.py``);
evaluation runs its ``single_device_model`` twin, which has the
same parameters and no sp axis.

``drain_pipeline`` applies a pipelined sync's last in-flight aggregate
after ``fit`` (under ZeRO, the parked shard aggregates through
``ZeroPlan.apply_shard_update``).

``GeoConfig(zero=True)`` binds a ``ZeroPlan`` into a copy of the sync
algorithm here (the caller's is never changed) and allocates the
optimizer state on the bucket shards; ``GeoConfig(multi_gps=True)``
allocates it on the mixed tree (``MultiGPSPlan.mixed_example``).

Models that size their layers from the input (the demo CNN, the MLP,
AlexNet, the ResNets' stem) are built from ``init_state``'s
``sample_input``, as the JAX ``init_state(rng, sample_input)`` sizes
them.  ``fit`` assembles batches ``config.prefetch`` ahead on a producer
thread (``GEOMX_PREFETCH``); ``fit(scan_epochs=True)`` runs each epoch
from a device-cached loader (``make_loader(device_cache=True)``) with no
host wait inside the epoch.  ``save_checkpoint``/``load_checkpoint``
write and read the JAX package's envelope (``utils/checkpoint.py``),
re-sharding ZeRO state onto another worker count (``train/zero.py``).

Membership epochs (``resilience/``): ``apply_membership`` binds a
live-party mask into the sync algorithm, swaps ``train_step`` to the
mask's step (built on first use, cached after) and applies the residual
policy; ``catchup_payload``/``admit_party`` carry the authoritative state
to a returning party, in the checkpoint tree format (under ZeRO through
``host_zero_state``/``place_zero_state``, which keep every worker's
shard).

The collective audit (``analysis/``, ``GEOMX_AUDIT``): ``fit`` arms the
auditor on its first batch, recording the installed step's collective
signature; ``apply_membership`` records the new mask's step and diffs
its signature against that reference (``GX-COLLECTIVE-002``) before the
swap, and a depth switch re-arms on the new step.  A program is recorded
by running it once on CPU zeros at the state's and the batch's shapes
and dtypes (the CPU RNG forked around it): the live state is never
read or written, nothing launches on the card, and every kernel wrapper
runs its plain version, which makes the same collective calls.  The cost
is one plain CPU step on the host at arming and at each swap
(``audit_record_ms``).  Findings at ``GEOMX_AUDIT_SEVERITY`` or above
raise ``AuditError`` with the active step left in place; below it they
warn.

Telemetry (``telemetry/``): with ``GEOMX_TELEMETRY`` the step carries
its probes (``train/step.py``) and ``fit`` publishes them at the log
boundaries it already waits on — registry gauges, the event log
(``GEOMX_TELEMETRY_EVENTS``), the flight recorder (``GEOMX_FLIGHT*``)
and the run capsule (``GEOMX_CAPSULE*``) — and brackets every step with
the profiler's ``train/step``/``train/compute`` spans, from which the
fit-end phase attribution is published.  ``publish_memory_metrics`` reads
the state's shapes and ``torch.cuda.max_memory_allocated``.

Control (``control/``): with ``GEOMX_CONTROL`` the state's sync state
carries the control operands (``init_state``) and ``apply_control`` is
the actuation boundary: a ratio decision writes the scale operand in
place (the next step makes the same launch calls), a depth decision
wraps or unwraps ``PipelinedSync`` with the dc-tier error feedback
carried across and the new step cached per (depth, membership) in
``_control_cache``.  As in the JAX package, the swap carries copy
``(0, 0)`` of the sync state into every slot, as ``apply_membership``'s
``"carry"`` does.  Under ``GEOMX_AUDIT`` a depth switch re-arms the
auditor on the new step.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU
and without that request it raises.

A device mesh (``Trainer(..., mesh=topology.build_mesh())``, the JAX
Trainer's ``mesh``) gives every replica slot a device of its own: the
state is placed per slot (``mesh.place``), the step runs one program a
slot (``train/step.py``), ``fit`` scatters each batch to the slots,
evaluation runs on slot ``(0, 0)``'s device, and checkpoints gather and
place, so a meshed run writes the stacked run's tensors.  The mesh runs
everything the stacked trainer runs (``init_state`` shapes a slot's
state by the step's plan), one program a slot: ``drain_pipeline``
drains once a slot; a membership change or a depth switch runs its
residual policy on slot ``(0, 0)``'s copy and places the result over
every slot; a catch-up payload comes from slot ``(0, 0)`` (under ZeRO
from party 0's worker row); a ratio decision writes every slot's own
scale operand; ``fit`` publishes slot ``(0, 0)``'s probes; the audit
records the meshed program on a CPU twin of the mesh (one record a
collective); the device-cached loader keeps one copy of the dataset a
distinct mesh device and hands each slot its block of each batch.  An
sp model runs on a ``[P, W, S]`` mesh
(``HiPSTopology(P, W, sp_degree=S).build_mesh()``), one sequence chunk
a slot.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.control.actuators import (CONTROL_KEY, control_enabled,
                                               init_control_operands)
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.ops.optim import fused_optim_enabled
from geomx_tpu_torch.parallel.collectives import run_on_mesh
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.topology import HiPSTopology, PlacedTree
from geomx_tpu_torch.train.state import (TrainState, replicate_tree,
                                         unreplicate_tree)
from geomx_tpu_torch.train.step import (build_eval_step, build_logits_fn,
                                        build_train_step, fused_bucketer,
                                        make_loss_fn, resolve_precision)
from geomx_tpu_torch.train.zero import (ZeroPlan, host_zero_state,
                                        place_zero_state,
                                        reshard_zero_state,
                                        zero_checkpoint_meta)
from geomx_tpu_torch.tree import leaf_names, state_map
from geomx_tpu_torch.utils import checkpoint
from geomx_tpu_torch.utils.metrics import Measure
from geomx_tpu_torch.utils.profiler import span


class Trainer:
    def __init__(self, model: torch.nn.Module, topology: HiPSTopology,
                 optimizer, sync=None, config: Optional[GeoConfig] = None,
                 device=None, single_device_model=None, mesh=None):
        """``single_device_model``: a twin of ``model`` with the same
        parameters and no sp axis, for evaluation; required to evaluate
        an sp-aware model.  ``mesh``: a ``topology.ReplicaMesh`` of the
        topology's ``[P, W]`` (module docstring), in place of
        ``device``."""
        if mesh is not None:
            if device is not None:
                raise ValueError("Trainer takes a device or a mesh, not "
                                 "both")
            for dev in mesh.distinct_devices():
                resolve_device(dev)
        self.mesh = mesh
        self.device = mesh.first_device if mesh is not None \
            else resolve_device(device)
        self.model = model
        self._sd_model = single_device_model or model
        self.topology = topology
        self.config = config or GeoConfig(
            num_parties=topology.num_parties,
            workers_per_party=topology.workers_per_party)
        self.sync = sync if sync is not None \
            else get_sync_algorithm(self.config)
        self.tx = optimizer
        self._precision = resolve_precision(self.config)
        compute_dtype = torch.bfloat16 if self._precision == "bf16" else None
        if self._precision == "bf16" and \
                getattr(model, "dtype", torch.float32) == torch.float32:
            warnings.warn(
                "GEOMX_PRECISION=bf16 but the model's compute dtype is "
                "float32: its layers will promote back to fp32. Build the "
                "model with get_model(name, precision='bf16')",
                stacklevel=2)
        sp_model = getattr(model, "sp_mode", None) is not None
        if getattr(topology, "sp_degree", 1) > 1 and not sp_model:
            warnings.warn(
                f"topology has sp_degree={topology.sp_degree} but the "
                "model declares no sp_mode: inputs stay replicated over "
                "the sp axis and every sp device computes the same thing "
                "— correct but wasted chips. Use an sp-aware model (e.g. "
                "SeqClassifier(sp_mode='ring')) or sp_degree=1.",
                RuntimeWarning, stacklevel=2)
        self.loss_fn = make_loss_fn(model, compute_dtype=compute_dtype)
        # the ZeRO plan binds here, onto the copy bind_zero returns, so
        # the trainer's own sync carries it (shard-shaped state, the
        # sharded drain); build_train_step reuses it
        if getattr(self.config, "zero", False):
            if getattr(self.sync, "supports_zero", False) \
                    and self.sync.zero_plan is None:
                self.sync = self.sync.bind_zero(
                    ZeroPlan(topology.workers_per_party))
        elif getattr(self.sync, "zero_plan", None) is not None:
            raise ValueError(
                "sync algorithm is ZeRO-bound (zero_plan set) but this "
                "trainer's config has zero=False: the step program would "
                "run the replicated update against shard-shaped sync "
                "state.  Pass a fresh (unbound) sync algorithm, or "
                "enable GEOMX_ZERO/GeoConfig(zero=True) to match")
        self._sp_model = sp_model
        self.train_step = build_train_step(self.loss_fn, self.tx, self.sync,
                                           topology, self.config,
                                           sp_model=sp_model, mesh=mesh)
        self._mgps = self.train_step.mgps
        # membership (resilience/): the bound mask (None = every party
        # live), its epoch version, and the step built for each mask
        self._membership = None
        self._membership_version = 0
        self._step_cache = {None: self.train_step}
        self._zero_plan = getattr(self.sync, "zero_plan", None)
        # fused apply: init_state puts the optimizer state on the dc
        # tier's bucket layout (build_train_step checked the stack)
        self._fused_optim = fused_optim_enabled(self.config)
        self.eval_step = build_eval_step(self._sd_model)
        self._logits_fn = build_logits_fn(self._sd_model)
        self._prefetch = max(0, int(getattr(self.config, "prefetch", 2)))
        # the control plane: init_state adds the operands, apply_control
        # is the actuation boundary; (depth, membership) -> step
        self._control = control_enabled(self.config)
        if self._control and not getattr(self.config, "control", False):
            # GEOMX_CONTROL armed it: pinned in the config, so the steps a
            # depth switch builds later carry the operands too
            self.config = dataclasses.replace(self.config, control=True)
        self._control_cache: dict = {}
        # the collective audit (analysis/): armed by fit's first batch;
        # every membership swap's step is diffed against the reference
        from geomx_tpu_torch.analysis import (audit_enabled,
                                              audit_severity_gate)
        self._audit = audit_enabled(self.config)
        self._audit_gate = audit_severity_gate(self.config) \
            if self._audit else "error"
        self._audit_args = None     # (state, x, y) shapes and dtypes
        self._audit_sigs: dict = {}  # membership key -> (signature, findings)
        self.audit_record_ms: list = []  # host ms of each recording
        self._init_telemetry()

    def _slot00(self, state):
        """Slot ``(0, 0)``'s copy of a placed state, else ``state``."""
        return state.slots[0] if isinstance(state, PlacedTree) else state

    def _stacked_replica00(self, tree):
        """Copy ``(0, 0)`` of a ``[P, W]`` tree (a slot's ``[1, 1]`` one
        too) replicated to ``[P, W]`` on this trainer's device."""
        return self._replicate_state(unreplicate_tree(tree))

    def _with_sync_state(self, state, sync_state):
        """``state`` with the stacked ``sync_state`` (control operands
        apart); a placed state gets it placed over every slot, each slot
        keeping its own control operands."""
        if not isinstance(state, PlacedTree):
            ctl = _split_control(state.sync_state)[1]
            return dataclasses.replace(
                state, sync_state=_join_control(sync_state, ctl))
        placed = self.mesh.place(sync_state)
        return PlacedTree(self.mesh, [
            dataclasses.replace(s, sync_state=_join_control(
                placed.slots[i], _split_control(s.sync_state)[1]))
            for i, s in enumerate(state.slots)])

    def _init_telemetry(self) -> None:
        """Arm the telemetry plane the config asks for, as the JAX
        Trainer's constructor does: the probe publisher, the flight ring
        and its incident feed, the run capsule (observatory tap and
        registry sampler, stopped by finalizers that hold the capsule,
        never the trainer) and the event log as the process default."""
        import weakref

        from geomx_tpu_torch.telemetry.capsule import capsule_from_config
        from geomx_tpu_torch.telemetry.flight import (
            flight_recorder_from_config, install_incident_recorder)
        from geomx_tpu_torch.telemetry.probes import telemetry_enabled
        self._telemetry = telemetry_enabled(self.config)
        self._memory_gauge_published = False
        self._flight = flight_recorder_from_config(self.config)
        if self._flight is not None:
            # host-plane incidents (restarts, wire-CRC rejections) land in
            # the recorder's incident ring, next to the step records
            install_incident_recorder(self._flight)
        self._attr_window_us = None  # trace mark of the last flight window
        if self._flight is not None and not self._telemetry:
            warnings.warn(
                "GEOMX_FLIGHT is on but telemetry is off: the flight "
                "recorder rides the in-graph step probes — enable "
                "GEOMX_TELEMETRY/GeoConfig(telemetry=True) or the ring "
                "records nothing", RuntimeWarning, stacklevel=3)
        self._capsule = capsule_from_config(self.config)
        if self._capsule is not None:
            from geomx_tpu_torch.telemetry.links import get_link_observatory
            self._capsule.attach_observatory(get_link_observatory())
            self._capsule.sampler.start()
            weakref.finalize(self, self._capsule.sampler.stop)
            weakref.finalize(self, self._capsule.detach_observatory)
            if not self._telemetry:
                warnings.warn(
                    "GEOMX_CAPSULE is on but telemetry is off: the "
                    "capsule's step records ride the published probes "
                    "— enable GEOMX_TELEMETRY/GeoConfig(telemetry="
                    "True) or the archive captures no sensor stream",
                    RuntimeWarning, stacklevel=3)
        self._event_log = None
        events_path = getattr(self.config, "telemetry_events", "")
        if events_path:
            from geomx_tpu_torch.telemetry.export import (
                EventLog, set_default_event_log)
            self._event_log = EventLog(events_path)
            # the process default too, so subsystems that only know the
            # global log_event() (membership transitions, relay failures)
            # land in the same file as the step probes
            set_default_event_log(self._event_log)

    def init_state(self, seed: int = 0,
                   generator: Optional[torch.Generator] = None,
                   params: Optional[dict] = None,
                   model_state: Optional[dict] = None,
                   sample_input=None) -> TrainState:
        """The replicated initial state.

        Weights come either from ``params``/``model_state`` — flat dicts
        of one replica's arrays, e.g. converted JAX weights
        (``models.convert.from_flax``) — or from the model's initializers
        drawn with ``generator`` (default: a CPU generator seeded with
        ``seed``).  ``sample_input`` (one local batch, ``[b, H, W, C]``)
        sizes the layers of a model that takes them from the input, as
        the JAX ``init_state(rng, sample_input)`` does; such a model
        needs it."""
        self._build_models(sample_input)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(int(seed))
            self.model.reset_parameters(generator)
            params = {k: p.detach() for k, p in
                      self.model.named_parameters()}
            model_state = {k: b.detach() for k, b in
                           self.model.named_buffers()}
        params = {k: torch.as_tensor(params[k], dtype=torch.float32)
                  for k in leaf_names(params)}
        model_state = {k: torch.as_tensor(v, dtype=torch.float32)
                       for k, v in (model_state or {}).items()}
        params = replicate_tree(params, self.topology, self.device)
        model_state = replicate_tree(model_state, self.topology, self.device)
        sync_state = None
        if self._mgps is not None:
            # MultiGPS: the optimizer and dc-tier state of the big leaves
            # are allocated a worker shard each
            mixed = self._mgps.mixed_example(params)
            opt_state = self.tx.init(mixed)
            sync_state = self.sync.init_state(mixed, model_state=model_state)
            dc = getattr(self.sync, "dc_compressor", None)
            if dc is not None and getattr(dc, "fuses_tree", False):
                # a tree-fusing dc compressor (DGT) runs one schedule a
                # layout group (train/step.py splits the same way)
                names = leaf_names(params)
                sizes = [math.prod(params[k].shape[2:]) for k in names]
                big, small = self._mgps.split_mixed(sizes, names)
                sync_state = dict(sync_state, dc_comp={
                    "sharded": dc.init_state({k: mixed[k] for k in big}),
                    "replicated": dc.init_state({k: mixed[k]
                                                 for k in small})})
        elif self._zero_plan is not None:
            # ZeRO: the optimizer runs on [P, W, n/W] bucket shards, so
            # its state is allocated shard-shaped; the sync's init sizes
            # the dc-tier residuals the same way
            opt_state = self.tx.init(self._zero_plan.shard_example(
                params, self._zero_plan.bucketed))
        elif self._fused_optim:
            # one [P, W, n] fp32 tensor a bucket, lane-padded sizes: the
            # layout the dc tier fuses gradients onto
            bk = fused_bucketer(self.sync)([params[k]
                                            for k in leaf_names(params)])
            lead = self.topology.replica_shape
            opt_state = self.tx.init([
                torch.zeros(lead + (n,), dtype=torch.float32,
                            device=self.device) for n in bk.bucket_sizes])
        else:
            opt_state = self.tx.init(params)
        if sync_state is None:
            sync_state = self.sync.init_state(params,
                                              model_state=model_state)
        if self._control:
            # the operands join sync_state: retuning them is an in-place
            # write of one 0-d tensor (control/actuators.py)
            if not isinstance(sync_state, dict):
                raise ValueError(
                    "GEOMX_CONTROL needs a dict-shaped sync state to "
                    f"carry its operands; {self.sync.name!r} returns "
                    f"{type(sync_state).__name__}")
            sync_state = dict(sync_state)
            sync_state[CONTROL_KEY] = init_control_operands(self.device)
        state = TrainState(step=0, params=params, opt_state=opt_state,
                           model_state=model_state, sync_state=sync_state)
        return state if self.mesh is None else self.mesh.place(state)

    def _build_models(self, sample_input) -> None:
        """Size the models' layers from one sample batch (models with a
        ``build``); without one, a model that needs it raises."""
        models = {id(m): m for m in (self.model, self._sd_model)}.values()
        if sample_input is None:
            for m in models:
                if not getattr(m, "built", True):
                    raise ValueError(
                        f"{type(m).__name__} sizes its layers from the "
                        "input: pass init_state(sample_input=x[:2])")
            return
        shape = tuple(np.shape(sample_input)[1:])
        for m in models:
            if hasattr(m, "build"):
                m.build(shape)

    # ---- membership epochs (resilience/) ---------------------------------

    def _replicate_state(self, tree):
        """Every array leaf of a host tree (numpy arrays, as one replica
        holds them) as a ``[P, W, ...]`` tensor on this trainer's device;
        other leaves as stored."""
        lead = self.topology.replica_shape

        def rep(x):
            if not isinstance(x, (np.ndarray, torch.Tensor)):
                return x
            x = torch.as_tensor(x, device=self.device)
            return x.expand(lead + tuple(x.shape)).contiguous()

        tree, ctl = _split_control(tree)
        if ctl is not None:
            ctl = state_map(lambda x: torch.as_tensor(
                x, dtype=torch.float32, device=self.device).clone(), ctl)
        return _join_control(state_map(rep, tree), ctl)

    @staticmethod
    def _replica_00(tree):
        """Copy ``(0, 0)`` of every tensor leaf of a state tree (a sync
        state's 0-d control operands as they are)."""
        tree, ctl = _split_control(tree)
        return _join_control(
            state_map(lambda x: x[0, 0] if isinstance(x, torch.Tensor)
                      else x, tree), ctl)

    def apply_membership(self, state: TrainState, epoch,
                         policy: Optional[str] = None) -> TrainState:
        """Bind a new membership epoch (a ``MembershipEpoch`` or a
        live-party mask).

        Rebinds the sync algorithm to the mask, swaps ``train_step`` to
        the mask's step (built on first use, cached after) and applies the
        residual policy to ``state.sync_state``: ``"reset"`` (default;
        ``GEOMX_RESILIENCE_RESIDUALS``) discards dc-tier error-feedback
        residuals and pipeline in-flight buffers accumulated under the old
        membership, ``"carry"`` keeps them.  Returns the adjusted state; a
        no-op when the mask is unchanged.

        As in the JAX package the policy runs on copy ``(0, 0)`` of the
        sync state, re-replicated over every slot (so under ``"carry"``
        every party resumes with party 0's residuals), and under ZeRO
        with ``"carry"`` the state is returned untouched: its dc-tier
        state holds per-worker shard content.

        Re-admission: call :meth:`catchup_payload` for the blob the
        returning party installs (:meth:`admit_party`) before this rebind
        widens the collective back over it.  A placed state keeps its
        params and optimizer state in every slot and gets the policy's
        sync state placed over the mesh."""
        from geomx_tpu_torch.topology import normalize_live_mask
        mask = normalize_live_mask(getattr(epoch, "live_mask", epoch),
                                   self.topology.num_parties)
        key = None if all(mask) else mask
        if key == self._membership:
            return state
        if self._mgps is not None:
            raise ValueError(
                "GEOMX_MULTI_GPS does not compose with membership "
                "changes (resilience/): the ZeRO-1 shards have no "
                "renormalized-survivor form")
        if policy is None:
            policy = getattr(self.config, "resilience_residuals",
                             None) or "reset"
        if policy not in ("reset", "carry"):
            # validated before any rebinding: a bad policy must not leave
            # the trainer half switched to the new mask
            raise ValueError(f"unknown residual policy {policy!r}: "
                             "expected 'reset' or 'carry'")
        prev = (self._membership, self._membership_version)
        self.sync.bind_membership(mask)
        self._membership = key
        self._membership_version = getattr(epoch, "version",
                                           self._membership_version + 1)
        step_fn = self._step_cache.get(key)
        if step_fn is None:
            step_fn = build_train_step(self.loss_fn, self.tx, self.sync,
                                       self.topology, self.config,
                                       sp_model=self._sp_model,
                                       mesh=self.mesh)
            self._step_cache[key] = step_fn
        # the audit at the swap (GEOMX_AUDIT): the new mask's step must
        # make the same ordered collective calls as the reference — a
        # mask changes operands, never collectives.  On AuditError the
        # sync is bound back to the previous mask (the steps share it),
        # so the active step runs on unchanged
        try:
            self._audit_membership_program(key, step_fn)
        except Exception:
            self.sync.bind_membership(
                [True] * self.topology.num_parties if prev[0] is None
                else prev[0])
            self._membership, self._membership_version = prev
            raise
        self.train_step = step_fn
        if self._zero_plan is not None and policy == "carry":
            return state
        s00 = self._slot00(state)
        sync_state = self._replicate_state(self._replica_00(
            _split_control(s00.sync_state)[0]))
        params = s00.params if s00 is state \
            else self._stacked_replica00(s00.params)
        return self._with_sync_state(state, self.sync.reset_comm_state(
            params, sync_state, policy))

    # ---- the collective audit (analysis/) ---------------------------------

    def _step_signature(self, step_fn):
        """Collective signature and single-program consistency findings of
        a step, recorded on CPU zeros at the armed shapes (module
        docstring); the host ms it took joins ``audit_record_ms``."""
        import time

        from geomx_tpu_torch.analysis import (AuditContext,
                                              CollectiveConsistencyPass,
                                              record_program)
        t0 = time.perf_counter()
        spec, xb, yb = self._audit_args
        st = _map_state(_cpu_zeros, spec)
        xb, yb = _cpu_zeros(xb), _cpu_zeros(yb)
        if self.mesh is not None:
            # the meshed program on a CPU twin of the mesh: the step runs
            # on the mesh its state is placed on
            st = self.mesh.on("cpu").place(st)
        with torch.random.fork_rng(devices=[]):
            rec = record_program(step_fn, st, xb, yb)
        ctx = AuditContext()
        findings = CollectiveConsistencyPass().run(rec, ctx)
        self.audit_record_ms.append(1e3 * (time.perf_counter() - t0))
        return ctx.extras["collective_signature"], findings

    def _audit_capture(self, state: TrainState, xb, yb) -> None:
        """Arm the auditor: keep the step arguments' shapes and dtypes
        and record the active step's collective signature (once a
        Trainer; the first fit batch with GEOMX_AUDIT on)."""
        if not self._audit or self._audit_args is not None:
            return
        self._audit_args = (_map_state(_spec, _stacked(state)),
                            _spec(_stacked(xb)), _spec(_stacked(yb)))
        self._audit_sigs[self._membership] = self._step_signature(
            self.train_step)

    def _audit_membership_program(self, key, step_fn) -> None:
        """Audit the membership step about to be installed: its
        collective signature is diffed against the armed reference
        (divergence is GX-COLLECTIVE-002, always error severity) and the
        step's own consistency findings join in.  Findings at or above
        GEOMX_AUDIT_SEVERITY raise AuditError; below it they warn."""
        if not self._audit or self._audit_args is None:
            return
        cached = self._audit_sigs.get(key)
        if cached is None:
            cached = self._step_signature(step_fn)
            self._audit_sigs[key] = cached
        sig, prog_findings = cached
        ref_key, (ref, _) = next(iter(self._audit_sigs.items()))
        if key == ref_key:
            return
        from geomx_tpu_torch.analysis import (diff_collective_signatures,
                                              enforce)
        findings = enforce(list(prog_findings) + diff_collective_signatures(
            {f"membership={ref_key}": ref, f"membership={key}": sig},
            rule_id="GX-COLLECTIVE-002"), self._audit_gate)
        if findings:  # below the gate: surface without stopping the run
            warnings.warn("\n".join(f.format() for f in findings),
                          RuntimeWarning, stacklevel=3)

    def catchup_payload(self, state: TrainState) -> bytes:
        """The re-admission catch-up blob: one copy of the full state
        (params, optimizer, model state and sync state) in the checkpoint
        tree format, what the survivors hand a returning party before
        ``apply_membership`` widens the collective back over it.  Copy
        ``(0, 0)``, except under ZeRO, where the shard-bearing fields
        keep party 0's whole worker axis (``host_zero_state``; on a mesh
        the slots of party 0, gathered)."""
        from geomx_tpu_torch.resilience.liveness import pack_catchup
        if self._zero_plan is not None:
            if isinstance(state, PlacedTree):
                state = self.mesh.gather(state, party=0)
            return pack_catchup(host_zero_state(state))
        state = self._slot00(state)
        return pack_catchup(TrainState(
            step=state.step, params=unreplicate_tree(state.params),
            opt_state=self._replica_00(state.opt_state),
            model_state=unreplicate_tree(state.model_state),
            sync_state=self._replica_00(state.sync_state)))

    def admit_party(self, payload: bytes) -> TrainState:
        """Install a catch-up payload as this trainer's state (the
        returning party's half of the protocol): the inverse of
        :meth:`catchup_payload`, replicated over every slot on this
        trainer's device (under ZeRO, each worker slot gets back its own
        shard, ``place_zero_state``); placed over the mesh on one."""
        from geomx_tpu_torch.resilience.liveness import unpack_catchup
        t = unpack_catchup(payload)
        if self._zero_plan is not None:
            state = place_zero_state(t, self.topology, self.device)
        else:
            state = TrainState(
                step=t["step"], params=self._replicate_state(t["params"]),
                opt_state=self._replicate_state(t["opt_state"]),
                model_state=self._replicate_state(t["model_state"]),
                sync_state=self._replicate_state(t["sync_state"]))
        return state if self.mesh is None else self.mesh.place(state)

    # ---- the control plane's actuation boundary (control/) ----------------

    def _dc_ratio_compressor(self):
        """The ratio-bearing dc-tier compressor (BiSparse, possibly under
        MPQ), unwrapped through the pipelined and bucketed layers; None
        when the dc tier carries no top-k ratio."""
        dc = getattr(self.sync, "dc_compressor", None)
        if dc is None:
            dc = getattr(getattr(self.sync, "inner", None),
                         "dc_compressor", None)
        while dc is not None and not hasattr(dc, "ratio") \
                and hasattr(dc, "inner"):
            dc = dc.inner
        if dc is not None and not hasattr(dc, "ratio"):
            # MPQ routes large tensors to its BiSparse half
            dc = getattr(dc, "large", None)
        return dc if dc is not None and hasattr(dc, "ratio") else None

    def control_depth(self) -> int:
        """The pipeline depth the installed step runs (0 or 1)."""
        from geomx_tpu_torch.sync.pipeline import PipelinedSync
        return 1 if isinstance(self.sync, PipelinedSync) else 0

    def apply_control(self, state: TrainState, decision) -> TrainState:
        """Apply one Graft Pilot decision.

        - ``kind == "ratio"``: write the new ``bsc_ratio_scale`` into the
          state's operand in place; the next step makes the same launch
          calls (no new step is built, no host round trip).
        - ``kind == "depth"``: wrap or unwrap ``PipelinedSync`` — a
          rebuild boundary modeled on :meth:`apply_membership` (a step
          cached per (depth, membership); the dc-tier error-feedback
          residuals carried across the swap; switching to 0 drains the
          in-flight aggregate first so no gradient is lost).

        Relay decisions are host-plane only and never reach this method
        (``ControlActuator`` routes them to the transport).  A placed
        state gets the ratio in every slot's own operand."""
        if not self._control:
            raise ValueError(
                "apply_control needs GEOMX_CONTROL/GeoConfig(control="
                "True): the step carries no control operands")
        kind = getattr(decision, "kind", None)
        if kind == "ratio":
            return self._apply_ratio(state, decision)
        if kind == "depth":
            return self._apply_depth(state, decision)
        raise ValueError(f"unknown control decision kind {kind!r}; "
                         "apply_control handles ratio | depth")

    def _apply_ratio(self, state: TrainState, decision) -> TrainState:
        comp = self._dc_ratio_compressor()
        if comp is None:
            raise ValueError(
                "ratio decision with no ratio-bearing dc compressor: "
                "configure bsc/mpq compression (the control scale tunes "
                "the top-k ratio)")
        target = float(decision.value)
        # the configured ratio is the wire capacity: the scale only
        # selects below it (the shapes never change)
        scale = min(max(target / float(comp.ratio), 1e-6), 1.0)
        # in place, on the current stream: the step reads the same tensor
        for s in state.slots if isinstance(state, PlacedTree) else [state]:
            s.sync_state[CONTROL_KEY]["bsc_ratio_scale"].fill_(scale)
        return state

    def _apply_depth(self, state: TrainState, decision) -> TrainState:
        from geomx_tpu_torch.sync.pipeline import PipelinedSync
        target = int(decision.value)
        if target not in (0, 1):
            raise ValueError(f"depth decision value must be 0 or 1 "
                             f"(got {decision.value!r})")
        current = self.control_depth()
        if target == current:
            return state
        if self._zero_plan is not None or self._mgps is not None:
            raise ValueError(
                "depth switching does not compose with GEOMX_ZERO/"
                "GEOMX_MULTI_GPS: their sharded updates re-layout the "
                "sync state this transition carries; pin the depth "
                "statically instead")
        if self.topology.num_parties <= 1:
            warnings.warn("depth decision ignored: num_parties=1 has "
                          "no dc-tier collective to pipeline",
                          RuntimeWarning, stacklevel=2)
            return state
        if target == 0:
            # land the in-flight aggregate before the swap: the parked
            # gradient applies exactly once, nothing is lost
            state = self.drain_pipeline(state)
        s00 = self._slot00(state)
        old_ss = _split_control(self._replica_00(s00.sync_state))[0]
        params, model_state = (state.params, state.model_state) \
            if s00 is state else (self._stacked_replica00(s00.params),
                                  self._stacked_replica00(s00.model_state))
        cache_key = (target, self._membership)
        step_fn = self._control_cache.get(cache_key)
        if step_fn is not None:
            new_sync = step_fn.sync
        elif target == 1:
            new_sync = PipelinedSync(
                self.sync, depth=1,
                dcasgd_lambda=self.config.pipeline_dcasgd)
        else:
            new_sync = copy.copy(self.sync.inner)
            # unwrap the PipelinedCompressor installed at wrap time; the
            # BucketedCompressor underneath (and its layout) is shared
            new_sync.dc_compressor = self.sync.inner.dc_compressor.inner
        new_sync.bind_topology(self.topology)
        if self._membership is not None:
            new_sync.bind_membership(self._membership)
        # state transition with EF carry: the dc-tier residuals live at
        # the same bucket coordinates on both sides of the swap
        fresh = self._replica_00(new_sync.init_state(
            params, model_state=model_state))
        if target == 1:
            inner_fresh = dict(fresh["inner"])
            for key, val in old_ss.items():
                if key == "dc_comp":
                    inner_fresh["dc_comp"] = dict(inner_fresh["dc_comp"],
                                                  inner=val)
                elif key in inner_fresh:
                    inner_fresh[key] = val
            fresh = dict(fresh, inner=inner_fresh)
        else:
            fresh = dict(fresh)
            for key, val in old_ss["inner"].items():
                if key == "dc_comp":
                    fresh["dc_comp"] = val["inner"]
                elif key in fresh:
                    fresh[key] = val
        if step_fn is None:
            step_fn = build_train_step(self.loss_fn, self.tx, new_sync,
                                       self.topology, self.config,
                                       sp_model=self._sp_model,
                                       mesh=self.mesh)
            step_fn.sync = new_sync
            self._control_cache[cache_key] = step_fn
        new_state = self._with_sync_state(state,
                                          self._replicate_state(fresh))
        # the audit across the swap: a depth change legitimately changes
        # the collective sequence, so the reference is re-armed on the new
        # step (its own findings gate before it is installed)
        if self._audit and self._audit_args is not None:
            _, xb_s, yb_s = self._audit_args
            self._audit_args = (_map_state(_spec, _stacked(new_state)),
                                xb_s, yb_s)
            sig, findings = self._step_signature(step_fn)
            from geomx_tpu_torch.analysis import enforce
            leftover = enforce(list(findings), self._audit_gate)
            if leftover:
                warnings.warn("\n".join(f.format() for f in leftover),
                              RuntimeWarning, stacklevel=2)
            self._audit_sigs = {self._membership: (sig, findings)}
        # install: the new sync owns the dc compressor stack from here;
        # membership steps built against the old one drop
        self.sync = new_sync
        self.train_step = step_fn
        self.config = dataclasses.replace(self.config,
                                          pipeline_depth=target)
        self._step_cache = {self._membership: step_fn}
        return new_state

    # ---- checkpointing ---------------------------------------------------

    def checkpoint_meta(self) -> dict:
        """The meta block a checkpoint of this trainer's state carries:
        whether the state is ZeRO-sharded and the topology it was
        sharded over, so :meth:`load_checkpoint` can re-shard onto a
        different worker count and reject a GEOMX_ZERO mismatch."""
        return zero_checkpoint_meta(self._zero_plan, self.topology)

    def save_checkpoint(self, path: str, state: TrainState,
                        step=None) -> str:
        """Save ``state`` with this trainer's layout meta.  The tensors
        keep their full ``[P, W, ...]`` replica axes, so a ZeRO run's
        per-worker shards are all captured (restoring onto the same
        topology is bit-exact, mid-pipeline buffers included).  A placed
        state is gathered first: a meshed run writes the stacked run's
        tensors."""
        if isinstance(state, PlacedTree):
            state = self.mesh.gather(state)
        return checkpoint.save_checkpoint(path, state, step=step,
                                          meta=self.checkpoint_meta())

    def load_checkpoint(self, path: str, template: TrainState) -> TrainState:
        """Restore a checkpoint into this trainer.

        ``template`` is a state with this trainer's structure and
        placement (fresh ``init_state`` output).  Rules, as in the JAX
        package:

        - the checkpoint's ZeRO flag must match this trainer's
          ``GEOMX_ZERO`` (else ``ValueError``);
        - same topology: leaves are placed directly (bit-exact resume,
          mid-pipeline buffers included);
        - another worker count (e.g. saved on 2x4, restored onto 2x2):
          shard-bearing leaves are gathered into full flat buckets and
          re-split (``train/zero.py`` ``reshard_zero_state``).

        Under a mesh ``template`` is placed, and so is the result."""
        if isinstance(template, PlacedTree):
            return self.mesh.place(self.load_checkpoint(
                path, self.mesh.gather(template)))
        host, meta = checkpoint.load_checkpoint(path, with_meta=True)
        ck_zero = bool((meta or {}).get("zero", False))
        if ck_zero != (self._zero_plan is not None):
            have = "GEOMX_ZERO=1" if ck_zero else "GEOMX_ZERO=0 (replicated)"
            want = "GEOMX_ZERO=1" if self._zero_plan is not None \
                else "GEOMX_ZERO=0 (replicated)"
            raise ValueError(
                f"checkpoint at {path!r} was saved with {have} but this "
                f"trainer runs {want}: the optimizer-state layouts are "
                "incompatible (sharded flat buckets vs replicated "
                "leaves).  Restore with a matching GEOMX_ZERO setting, "
                "or re-save from a trainer in the target mode")
        topo_meta = (int((meta or {}).get("num_parties",
                                          self.topology.num_parties)),
                     int((meta or {}).get("workers_per_party",
                                          self.topology.workers_per_party)))
        here = (self.topology.num_parties, self.topology.workers_per_party)
        if not ck_zero or topo_meta == here:
            return checkpoint.place_like(host, template)
        return reshard_zero_state(host, template)

    def drain_pipeline(self, state: TrainState) -> TrainState:
        """Apply a pipelined sync's completed in-flight dc-tier aggregate
        without feeding a batch (``sync/pipeline.py``): after the last
        ``fit``, the last launched gradient and its model-state
        (BatchNorm) aggregate have not been applied.  A no-op for
        algorithms without ``drain_grads``.  No collectives run but
        ZeRO's all-gather of the params: the buffers hold reduced values.
        The gradient buffer comes back zeroed (a later ``fit`` warms up
        again); the model-state buffer keeps the applied value.  Under
        ZeRO the parked shard aggregates go through
        ``ZeroPlan.apply_shard_update``, the fused kernels included, as
        in the JAX package.  A placed state drains once a slot
        (``run_on_mesh``: ZeRO's all-gather meets the other slots'), and
        the result is placed."""
        sync = self.sync
        if not hasattr(sync, "drain_grads"):
            return state
        if self._zero_plan is None and self._fused_optim:
            # the JAX package's drain (geomx_tpu/train/trainer.py:789)
            # hands the leaf-tree aggregate to tx.update against the
            # optimizer state on the bucket layout, and raises
            # ValueError for the mismatched trees; so does the port
            raise ValueError(
                "Trainer.drain_pipeline does not compose with "
                "GEOMX_FUSED_OPTIM: the drained aggregate is a leaf tree "
                "and the fused optimizer state lives on the dc tier's "
                "flat buckets (the JAX package's drain raises too)")
        if isinstance(state, PlacedTree):
            outs = run_on_mesh(self._drain, self.mesh,
                               [(s,) for s in self.mesh.place(state).slots])
            return PlacedTree(self.mesh, outs)
        return self._drain(state)

    def _drain(self, state: TrainState) -> TrainState:
        """:meth:`drain_pipeline`'s body on one (stacked or slot) state."""
        sync = self.sync
        zplan = self._zero_plan
        if zplan is not None:
            with span("train/drain"):
                g_sh, sync_state = sync.drain_grad_shards(state.params,
                                                          state.sync_state)
                params, opt_state = zplan.apply_shard_update(
                    self.tx, g_sh, state.params, state.opt_state)
                model_state, sync_state = sync.drain_model_state(
                    state.model_state, sync_state)
            return TrainState(step=state.step, params=params,
                              opt_state=opt_state, model_state=model_state,
                              sync_state=sync_state)
        with span("train/drain"):
            g, sync_state = sync.drain_grads(state.params, state.sync_state)
            params, opt_state = self.tx.update(g, state.opt_state,
                                               state.params)
            model_state, sync_state = sync.drain_model_state(
                state.model_state, sync_state)
        return TrainState(step=state.step, params=params,
                          opt_state=opt_state, model_state=model_state,
                          sync_state=sync_state)

    def make_loader(self, x, y, batch_size: int, split_by_class: bool = False,
                    seed: int = 0, augment: bool = False,
                    device_cache: bool = False) -> GeoDataLoader:
        """``device_cache=True`` keeps the dataset on this trainer's
        device (on a mesh, on each distinct mesh device) and gathers each
        batch there (``data/loader.py``), the input of
        ``fit(scan_epochs=True)``."""
        return GeoDataLoader(x, y, self.topology, batch_size,
                             split_by_class=split_by_class, seed=seed,
                             augment=augment, device=self.device,
                             device_cache=device_cache,
                             mesh=self.mesh if device_cache else None,
                             seq_dim=3 if self._sp_model else None)

    def predict_logits(self, state: TrainState, x: np.ndarray,
                       batch_size: int = 512) -> np.ndarray:
        """Logits of replica (0, 0) over a host array, as an fp32 numpy
        array (the one evaluation forward ``Module.predict``/``score``
        use)."""
        state = self._slot00(state)
        params = unreplicate_tree(state.params)
        model_state = unreplicate_tree(state.model_state)
        outs = []
        for s in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.ascontiguousarray(x[s:s + batch_size]),
                                 device=self.device)
            logits = self._logits_fn(params, model_state, xb)
            outs.append(logits.float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def evaluate(self, state: TrainState, x: np.ndarray, y: np.ndarray,
                 batch_size: int = 512) -> float:
        """Test accuracy of replica (0, 0) over ``(x, y)``."""
        state = self._slot00(state)
        params = unreplicate_tree(state.params)
        model_state = unreplicate_tree(state.model_state)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.ascontiguousarray(x[s:s + batch_size]),
                                 device=self.device)
            yb = torch.as_tensor(np.asarray(y[s:s + batch_size]),
                                 device=self.device).long()
            c, _ = self.eval_step(params, model_state, xb, yb)
            correct += c
        return int(correct) / max(len(x), 1)

    def run_epoch(self, state: TrainState, loader: GeoDataLoader,
                   epoch: int):
        """One epoch from a device-cached loader: the epoch's indices
        uploaded once, each step's batch gathered on the device, the
        metrics kept on the device and stacked at the end, so the host
        never waits inside the epoch.  Returns ``(state, {"loss":
        [steps], "accuracy": [steps]})`` on the device.  On a mesh each
        batch is gathered on every mesh device, each slot taking its
        block, and the metrics are slot ``(0, 0)``'s."""
        sel, gen = loader.epoch_indices(epoch)
        sel = torch.as_tensor(sel, device=self.device)
        losses, accs = [], []
        telem = None
        for xb, yb in loader.cached_batches(sel, gen):
            self._audit_capture(state, xb, yb)
            state, metrics = self.train_step(state, xb, yb)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
            telem = metrics.get("telemetry", telem)
        out = {"loss": torch.stack(losses), "accuracy": torch.stack(accs)}
        if telem is not None:
            # the epoch's last step's probes (what the JAX scanned epoch
            # publishes), still on the device
            out["telemetry"] = telem
        return state, out

    def fit(self, state: TrainState, loader: GeoDataLoader, epochs: int = 1,
            eval_data=None, eval_every: int = 0, log_every: int = 0,
            log_fn: Callable[[str], None] = print,
            measure: Optional[Measure] = None, scan_epochs: bool = False):
        """Run the training loop.

        - ``log_every=N``: record/log loss and train accuracy every N
          iterations (the only points where the host waits for the card);
        - ``eval_every=N``: test accuracy every N iterations; 0 = at each
          epoch end;
        - ``scan_epochs=True`` (requires a device-cached loader) runs each
          epoch with no host wait inside it (:meth:`run_epoch`), as the
          JAX package's scanned epoch: logging coarsens to one record an
          epoch (the epoch's mean loss and accuracy), and evaluation runs
          between epochs.  The state is the per-step loop's.

        With telemetry on, the step probes are published at the log
        boundaries (with ``log_every=0``, once an epoch), and the fit-end
        phase attribution when the profiler runs.

        Returns ``(state, list of record dicts)``."""
        from geomx_tpu_torch.utils.profiler import get_profiler
        measure = measure if measure is not None else Measure()
        measure.reset_clock()
        # the attribution windows start at this fit
        prof = get_profiler()
        fit_since_us = prof.now_us() if prof.running else None
        self._attr_window_us = fit_since_us
        if scan_epochs:
            if not getattr(loader, "device_cache", False):
                raise ValueError("scan_epochs requires device_cache=True "
                                 "on the loader")
            it = 0
            for epoch in range(epochs):
                state, ms = self.run_epoch(state, loader, epoch)
                it += loader.steps_per_epoch
                fields = {}
                if log_every:
                    fields.update(loss=float(ms["loss"].mean()),
                                  train_acc=float(ms["accuracy"].mean()))
                if self._telemetry and "telemetry" in ms:
                    self._publish_telemetry(ms["telemetry"], it)
                if eval_data is not None:
                    fields["test_acc"] = self.evaluate(state, *eval_data)
                if fields:
                    rec = measure.add(epoch=epoch, iteration=it, **fields)
                    log_fn(json.dumps(rec))
            self._capsule_checkpoint(prof)
            return state, measure.records
        it = 0
        metrics = None
        for epoch in range(epochs):
            for xb, yb in loader.epoch(epoch, prefetch=self._prefetch):
                # arm the auditor on the first batch (a no-op unless
                # GEOMX_AUDIT is on)
                self._audit_capture(state, xb, yb)
                # step-time attribution (telemetry/attribution.py): every
                # step is a train/step + train/compute span pair while
                # the profiler runs (scope() is a no-op when it does
                # not); the log boundary's wait stays inside the compute
                # span, as in the JAX fit loop
                with prof.scope("train/step", "step", args={"step": it}):
                    with prof.scope("train/compute", "compute"):
                        state, metrics = self.train_step(state, xb, yb)
                        it += 1
                        fields = {}
                        if log_every and it % log_every == 0:
                            fields.update(
                                loss=float(metrics["loss"]),
                                train_acc=float(metrics["accuracy"]))
                if self._telemetry:
                    if not self._memory_gauge_published:
                        # once a trainer, after the first step: the state
                        # bytes a replica and the card's peak
                        self.publish_memory_metrics(state)
                    if fields and "telemetry" in metrics:
                        self._publish_telemetry(metrics["telemetry"], it)
                if eval_data is not None and eval_every \
                        and it % eval_every == 0:
                    fields["test_acc"] = self.evaluate(state, *eval_data)
                if fields:
                    rec = measure.add(epoch=epoch, iteration=it, **fields)
                    log_fn(json.dumps(rec))
            if self._telemetry and not log_every and it \
                    and "telemetry" in metrics:
                # no log boundary synced this epoch: publish its last
                # step so the registry and the event log still track a
                # log_every=0 run (one read an epoch)
                self._publish_telemetry(metrics["telemetry"], it)
            if eval_data is not None and not eval_every:
                rec = measure.add(epoch=epoch, iteration=it,
                                  test_acc=self.evaluate(state, *eval_data))
                log_fn(json.dumps(rec))
        if self._telemetry and prof.running:
            # the fit's phase-fraction summary from the step spans above
            # (geomx_phase_fraction gauges)
            from geomx_tpu_torch.telemetry.attribution import (
                attribute_trace, publish_attribution)
            att = attribute_trace(prof.to_doc(), since_us=fit_since_us)
            if att["num_steps"]:
                publish_attribution(att["summary"])
        self._capsule_checkpoint(prof)
        return state, measure.records

    # ---- telemetry (telemetry/) ------------------------------------------

    def _publish_telemetry(self, telem: dict, iteration: int) -> None:
        """Publish one step's probe dict to the metric registry, the
        event log, the capsule and the flight recorder.  The tensors come
        to the host in one copy (``host_probes``).  Scalars become
        ``geomx_step_probe{probe=...}`` gauges, per-party vectors
        ``geomx_step_probe_party{probe=...,party=...}``.  The byte and
        step counters are the program's own (``collectives._record``,
        ``utils/profiler.StepClock``)."""
        from geomx_tpu_torch.telemetry import get_registry, log_event
        from geomx_tpu_torch.telemetry.probes import host_probes
        reg = get_registry()
        fam = reg.gauge("geomx_step_probe",
                        "Latest published in-graph step probe", ("probe",))
        fam_p = reg.gauge("geomx_step_probe_party",
                          "Latest per-party in-graph step probe",
                          ("probe", "party"))
        flat = host_probes(telem)
        for name, val in flat.items():
            if isinstance(val, list):
                for p, v in enumerate(val):
                    fam_p.labels(probe=name, party=str(p)).set(v)
            else:
                fam.labels(probe=name).set(val)
        dc = getattr(self.sync, "dc_compressor", None)
        if dc is None:  # PipelinedSync wraps the algorithm that has it
            dc = getattr(getattr(self.sync, "inner", None),
                         "dc_compressor", None)
        while dc is not None and not hasattr(dc, "layout_summary") \
                and hasattr(dc, "inner"):
            dc = dc.inner  # unwrap Pipelined/DGT wrappers to the bucketer
        layout = getattr(dc, "layout_summary", None)
        layout = layout() if callable(layout) else None
        if layout:
            reg.gauge("geomx_bucket_count",
                      "dc-tier fused buckets per step").set(
                layout["num_buckets"])
            reg.gauge("geomx_bucket_pad_fraction",
                      "Lane-padding waste in the bucket layout").set(
                layout["pad_fraction"])
            if self._zero_plan is not None:
                w = self._zero_plan.W
                reg.gauge("geomx_zero_workers",
                          "Worker-axis width the weight update is "
                          "sharded over").set(w)
                reg.gauge("geomx_zero_shard_elems",
                          "Flat bucket elements owned per chip under "
                          "the ZeRO-sharded update").set(
                    layout["padded_elems"] / w)
        if self._zero_plan is not None:
            reg.gauge("geomx_zero_enabled",
                      "1 when the ZeRO-sharded weight update is "
                      "active").set(1.0)
        if self._event_log is not None:
            self._event_log.emit("step_probes", iteration=iteration,
                                 **flat)
        else:
            log_event("step_probes", iteration=iteration, **flat)
        if self._capsule is not None:
            # the sensor surface as a control tick reads it (the registry
            # gauge families): what makes the capsule's replayed
            # observation stream bit-identical to the live one
            self._capsule.record_step(iteration)
        if self._flight is not None:
            fired = self._flight.record(
                iteration, flat,
                membership_version=self._membership_version,
                phases=self._attribution_phases())
            if fired:
                ev = dict(iteration=iteration, fired=fired,
                          bundle=(self._flight.dumps[-1]
                                  if self._flight.dumps else None))
                if self._event_log is not None:
                    self._event_log.emit("flight_anomaly", **ev)
                else:
                    log_event("flight_anomaly", **ev)

    def _attribution_phases(self) -> Optional[dict]:
        """Phase-fraction summary of the ``train/step`` spans the host
        profiler recorded since the previous publish (None when the
        profiler is off or no step span landed in the window): the
        ``phases`` the flight recorder's exposed_comms_jump rule
        watches.  Advances the window mark."""
        from geomx_tpu_torch.utils.profiler import get_profiler
        prof = get_profiler()
        if not prof.running:
            return None
        from geomx_tpu_torch.telemetry.attribution import attribute_trace
        att = attribute_trace(prof.to_doc(), since_us=self._attr_window_us)
        self._attr_window_us = prof.now_us()
        if not att["num_steps"]:
            return None
        return att["summary"]

    def step_memory_stats(self, state: TrainState) -> dict:
        """Step memory accounting: the bytes of optimizer, sync and
        parameter state one replica slot holds (from the state's tensor
        shapes; every slot holds the same shapes), and on the card the
        allocator's peak (``torch.cuda.max_memory_allocated``).  The JAX
        package reads XLA's ``compiled.memory_analysis()``; an eager
        PyTorch step has no compiled program.  Under a mesh: slot ``(0,
        0)``'s bytes, and the peak of its device."""
        slots = max(1, self.topology.num_parties
                    * self.topology.workers_per_party)
        if isinstance(state, PlacedTree):
            state, slots = state.slots[0], 1

        def per_slot_bytes(tree):
            total = 0

            def add(x):
                nonlocal total
                if isinstance(x, torch.Tensor):
                    total += x.numel() * x.element_size()
                return x
            state_map(add, tree)
            return total / slots

        out = {
            "opt_state_bytes_per_chip": per_slot_bytes(state.opt_state),
            "sync_state_bytes_per_chip": per_slot_bytes(state.sync_state),
            "params_bytes_per_chip": per_slot_bytes(state.params),
        }
        dev = torch.device(self.device)
        if dev.type == "cuda":
            out["peak_allocated_bytes"] = float(
                torch.cuda.max_memory_allocated(dev))
        return out

    def publish_memory_metrics(self, state: TrainState) -> None:
        """Publish the per-slot step-memory gauges (once a trainer):
        ``geomx_step_memory_bytes{component}`` for the optimizer, sync
        and parameter state, and ``peak_allocated`` on the card."""
        if self._memory_gauge_published:
            return
        self._memory_gauge_published = True
        from geomx_tpu_torch.telemetry import get_registry
        stats = self.step_memory_stats(state)
        fam = get_registry().gauge(
            "geomx_step_memory_bytes",
            "Per-chip training-step memory by component", ("component",))
        for comp in ("opt_state_bytes_per_chip",
                     "sync_state_bytes_per_chip",
                     "params_bytes_per_chip"):
            fam.labels(component=comp.replace("_bytes_per_chip", "")) \
                .set(float(stats[comp]))
        if "peak_allocated_bytes" in stats:
            fam.labels(component="peak_allocated").set(
                stats["peak_allocated_bytes"])

    def _capsule_checkpoint(self, prof) -> None:
        """Refresh the run capsule at a fit boundary: attach the latest
        profiler trace (replacing this rank's previous one) and rewrite
        the archive atomically."""
        if self._capsule is None:
            return
        if prof.running:
            rank = getattr(prof, "rank", None)
            self._capsule.add_trace(
                prof.to_doc(), label=f"rank{rank if rank is not None else 0}")
        self._capsule.write()

    def close_capsule(self) -> None:
        """Finish capsule recording: stop the sampler, detach the
        observatory tap and write the final archive.  (A garbage-collected
        trainer stops its sampler and tap through finalizers, but does
        not write.)"""
        if self._capsule is not None:
            self._capsule.close()


def _split_control(sync_state):
    """``(sync_state without its control operands, the operands or
    None)``: the operands are 0-d tensors outside the ``[P, W]`` replica
    layout every other state leaf has."""
    if isinstance(sync_state, dict) and CONTROL_KEY in sync_state:
        rest = dict(sync_state)
        return rest, rest.pop(CONTROL_KEY)
    return sync_state, None


def _join_control(sync_state, ctl):
    """The inverse of :func:`_split_control`."""
    if ctl is None:
        return sync_state
    return dict(sync_state, **{CONTROL_KEY: ctl})


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A tensor's shape and dtype (the audit's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _spec(x):
    if isinstance(x, torch.Tensor):
        return _Spec(tuple(x.shape), x.dtype)
    return x


def _stacked(tree):
    """A placed tree's stacked shapes (meta tensors), else ``tree``."""
    if isinstance(tree, PlacedTree):
        return tree.mesh.gather(tree, device="meta")
    return tree


def _cpu_zeros(x):
    if isinstance(x, _Spec):
        return torch.zeros(x.shape, dtype=x.dtype)
    return x


def _map_state(fn, state: TrainState) -> TrainState:
    """``state_map(fn, ...)`` over every field of a TrainState."""
    return TrainState(**{f.name: state_map(fn, getattr(state, f.name))
                         for f in dataclasses.fields(state)})
