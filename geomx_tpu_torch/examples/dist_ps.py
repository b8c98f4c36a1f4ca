"""Process-separated HiPS training via the host-side PS service (port of
examples/dist_ps.py).

The reference's launch model runs one OS process per node role, configured
entirely by environment variables (scripts/cpu/run_vanilla_hips.sh:8-148;
roles in 3rdparty/ps-lite/include/ps/internal/message.h:74; non-worker
processes become blocking servers inside ``import mxnet``,
python/mxnet/kvstore_server.py:30-89).  This demo reproduces that shape
with geomx_tpu_torch's GeoPSServer/GeoPSClient:

  GEOMX_ROLE=global_server   — a global PS tier process (MultiGPS: run
                               GEOMX_NUM_GLOBAL_SERVERS of these, ids via
                               GEOMX_GS_ID, ports GLOBAL_PORT+id)
  GEOMX_ROLE=server          — a party's local PS; relays to the global tier
  GEOMX_ROLE=worker          — trains, push/pull against its party's server

Topology env (reference DMLC_* analogues):
  GEOMX_NUM_PARTIES, GEOMX_WORKERS_PER_PARTY — cluster shape
  GEOMX_PARTY_ID, GEOMX_WORKER_ID            — this process's coordinates
  GEOMX_PS_GLOBAL_PORT, GEOMX_PS_PORT        — listen/connect ports
  GEOMX_SYNC_MODE  fsa|mixed                 — maps to server sync/async
  GEOMX_COMPRESSION e.g. "bsc,0.01" | "fp16" — cross-party hop compression
  PS_RESEND/PS_RESEND_TIMEOUT/PS_DROP_MSG    — reliability/fault injection

Run the full multi-process topology on localhost (the reference's
pseudo-distributed mode) through the port's launcher:

    python -m geomx_tpu_torch.launch --num-parties 2 --workers-per-party 2 \
        -- python -m geomx_tpu_torch.examples.dist_ps -c

Workers compute their gradients with torch on the card, or on the CPU
with ``-c``; without a card and without ``-c`` they raise.  (The JAX
example pins its workers to the CPU because processes cannot share a
TPU; processes can share one GPU.)  The servers run on the card too
unless ``-c``: a local server's relay compressor and a non-native
server-side optimizer run there, the store stays numpy.
"""

import argparse
import os

import numpy as np


def env(name, default=None, cast=str):
    v = os.environ.get(name)
    return cast(v) if v not in (None, "") else default


ROLE = env("GEOMX_ROLE", "worker")
NUM_PARTIES = env("GEOMX_NUM_PARTIES", 2, int)
WORKERS_PER_PARTY = env("GEOMX_WORKERS_PER_PARTY", 2, int)
PARTY_ID = env("GEOMX_PARTY_ID", 0, int)
WORKER_ID = env("GEOMX_WORKER_ID", 0, int)
GLOBAL_PORT = env("GEOMX_PS_GLOBAL_PORT", 19700, int)
LOCAL_PORT = env("GEOMX_PS_PORT", 19800, int)  # + party_id
# MultiGPS on the host plane (reference kvstore_dist_server.h:1786-1826):
# N global-server processes at GLOBAL_PORT..GLOBAL_PORT+N-1
NUM_GLOBAL_SERVERS = env("GEOMX_NUM_GLOBAL_SERVERS", 1, int)
GS_ID = env("GEOMX_GS_ID", 0, int)
# central scheduler (reference ADD_NODE/Postoffice): with
# GEOMX_USE_SCHEDULER=1 every process registers for a node id and
# discovers peer addresses from the roster instead of env wiring
USE_SCHEDULER = env("GEOMX_USE_SCHEDULER", 0, int)
SCHED_PORT = env("GEOMX_SCHEDULER_PORT", 19600, int)
# multi-host: where the tiers live (reference DMLC_PS_GLOBAL_ROOT_URI /
# DMLC_PS_ROOT_URI; localhost for the pseudo-distributed mode)
GLOBAL_HOST = (env("GEOMX_PS_GLOBAL_HOST")
               or env("DMLC_PS_GLOBAL_ROOT_URI") or "127.0.0.1")
LOCAL_HOST = env("GEOMX_PS_HOST") or env("DMLC_PS_ROOT_URI") or "127.0.0.1"
SYNC = env("GEOMX_SYNC_MODE", "fsa")
HFA_K1 = env("GEOMX_HFA_K1", 20, int)  # local steps per local sync
HFA_K2 = env("GEOMX_HFA_K2", 10, int)  # local syncs per global sync
COMPRESSION = env("GEOMX_COMPRESSION", None)
ENABLE_DGT = env("GEOMX_ENABLE_DGT", 0, int) or env("ENABLE_DGT", 0, int)
EPOCHS = env("GEOMX_EPOCHS", 3, int)
BATCH = env("GEOMX_BATCH", 64, int)
LR = env("GEOMX_LR", 0.1, float)
# hfa is sync intra-party with K2-periodic global relays (the server-side
# half of HFA); mixed maps to the async server
MODE = "async" if SYNC in ("mixed", "dist_async", "async") else "sync"


def save_stats(tag, round_ms=None):
    """With ``GEOMX_SAVE_PARAMS`` set, each process also writes its
    socket counters (``WireStats``) and, for a worker, the wall time of
    each push-and-pull round to ``stats_<tag>.json`` there."""
    save_dir = env("GEOMX_SAVE_PARAMS")
    if not save_dir:
        return
    import json

    from geomx_tpu_torch.service.protocol import wire_stats
    doc = {"role": ROLE, "wire": wire_stats.snapshot()}
    if round_ms is not None:
        doc["round_ms"] = round_ms
    with open(os.path.join(save_dir, f"stats_{tag}.json"), "w") as f:
        json.dump(doc, f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def run_scheduler(device):
    from geomx_tpu_torch.service import GeoScheduler
    sched = GeoScheduler(port=SCHED_PORT).start()
    print(f"[scheduler] listening on {SCHED_PORT}", flush=True)
    sched.join()
    save_stats("scheduler")
    print("[scheduler] stopped", flush=True)


def _sched_client():
    from geomx_tpu_torch.service import SchedulerClient
    return SchedulerClient((GLOBAL_HOST, SCHED_PORT))


def run_global_server(device):
    from geomx_tpu_torch.service import GeoPSServer
    # HFA: the global store accumulates parties' milestone deltas onto the
    # initial params, so it always holds the authoritative model
    port = GLOBAL_PORT + GS_ID
    # ENABLE_INTER_TS: the global tier also disseminates fresh params
    # down to the local servers (AutoPull with the global server as node
    # 0) — requires the auto_pull distributor, single-global only
    inter_ts = bool(env("GEOMX_ENABLE_INTER_TS", 0, int)
                    or env("ENABLE_INTER_TS", 0, int))
    srv = GeoPSServer(port=port, num_workers=NUM_PARTIES,
                      mode=MODE, rank=GS_ID,
                      auto_pull=inter_ts and NUM_GLOBAL_SERVERS == 1,
                      accumulate=(SYNC == "hfa"), device=device).start()
    sc = None
    if USE_SCHEDULER:
        sc = _sched_client()
        # advertise the address PEERS use to reach this node, not
        # loopback — on multi-host deployments that is the launcher-set
        # GLOBAL_HOST (this process runs on that host)
        sc.register("global_server", host=GLOBAL_HOST, port=port,
                    tag=str(GS_ID))
        # keep the scheduler's liveness view fed for the process lifetime
        # (reference Van::Heartbeat timer)
        sc.start_heartbeat()
    print(f"[global_server {GS_ID}] listening on {port} "
          f"({NUM_PARTIES} parties, {MODE})", flush=True)
    srv.join()
    save_stats(f"global_server{GS_ID}")
    if sc is not None:
        if GS_ID == 0:   # last one out turns off the lights
            sc.stop_scheduler()
        sc.close()
    print(f"[global_server {GS_ID}] stopped", flush=True)


def run_local_server(device):
    from geomx_tpu_torch.service import GeoPSServer
    port = LOCAL_PORT + PARTY_ID
    sc = None
    if USE_SCHEDULER:
        # discover the global tier from the roster (sorted by node id, so
        # every party sees the same shard order)
        sc = _sched_client()
        # LOCAL_HOST is this party's host (launcher sets GEOMX_PS_HOST
        # per party for multi-host runs) — the address workers dial
        sc.register("server", host=LOCAL_HOST, port=port,
                    tag=str(PARTY_ID))
        sc.start_heartbeat()
        gaddrs = [(h, p) for (_id, h, p, _t) in
                  sc.wait_for("global_server", NUM_GLOBAL_SERVERS)]
    else:
        gaddrs = [(GLOBAL_HOST, GLOBAL_PORT + i)
                  for i in range(NUM_GLOBAL_SERVERS)]
    srv = GeoPSServer(port=port, num_workers=WORKERS_PER_PARTY, mode=MODE,
                      global_addrs=gaddrs,
                      compression=COMPRESSION, rank=1 + PARTY_ID,
                      global_sender_id=1000 + PARTY_ID,
                      hfa_k2=HFA_K2 if SYNC == "hfa" else None,
                      num_global_workers=NUM_PARTIES, device=device).start()
    print(f"[server p{PARTY_ID}] listening on {port} "
          f"({WORKERS_PER_PARTY} workers, compression={COMPRESSION})",
          flush=True)
    srv.join()
    save_stats(f"server_p{PARTY_ID}")
    if sc is not None:
        sc.close()
    print(f"[server p{PARTY_ID}] stopped", flush=True)


def make_data(n=2048, d=64, classes=10):
    """Per-worker shard of a fixed synthetic classification problem — the
    SplitSampler semantics (reference examples/utils.py:10-22): same
    dataset everywhere, disjoint part per global worker rank."""
    rng = np.random.RandomState(0)
    w_true = rng.normal(size=(d, classes)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.normal(size=(n, classes)), axis=1)
    total = NUM_PARTIES * WORKERS_PER_PARTY
    rank = PARTY_ID * WORKERS_PER_PARTY + WORKER_ID
    part = n // total
    sl = slice(rank * part, (rank + 1) * part)
    return x[sl], y[sl].astype(np.int32), x[:512], y[:512].astype(np.int32)


def run_worker(device):
    import torch

    from geomx_tpu_torch.service import GeoPSClient

    print(f"[worker p{PARTY_ID}w{WORKER_ID}] device {device}", flush=True)

    sc = None
    if USE_SCHEDULER:
        # find THIS party's server through the roster instead of env math
        sc = _sched_client()
        sc.register("worker", host=LOCAL_HOST, port=0,
                    tag=f"{PARTY_ID}.{WORKER_ID}")
        sc.start_heartbeat()
        entry = sc.wait_for("server", 1, tag=str(PARTY_ID))[0]
        server_addr = (entry[1], entry[2])
    else:
        server_addr = (LOCAL_HOST, LOCAL_PORT + PARTY_ID)
    resend = env("PS_RESEND", 0, int)
    # intra-party TSEngine (ENABLE_INTRA_TS): push side joins the ASK1
    # relay overlay (ts_push), pull side consumes server-initiated
    # AutoPull updates — the reference's full TS data path
    intra_ts = bool(env("GEOMX_ENABLE_INTRA_TS", 0, int)
                    or env("ENABLE_INTRA_TS", 0, int))
    c = GeoPSClient(server_addr, sender_id=WORKER_ID,
                    resend_timeout_ms=1000 if resend else None,
                    auto_pull=intra_ts,
                    ts_node=WORKER_ID + 1 if intra_ts else None)
    # resume round counters from any prior incarnation of this sender id:
    # pushes carry per-key round ids and the server idempotently absorbs
    # rounds it already merged, so a restarted worker that kept round=1
    # would have every push silently deduped
    prior = c.recover()
    if any(prior.values()):
        print(f"[worker p{PARTY_ID}w{WORKER_ID}] resuming: "
              f"server has {sum(prior.values())} merged rounds", flush=True)

    d, classes = 64, 10
    x, y, xt, yt = make_data()
    rng = np.random.RandomState(0)  # identical init on every worker
    params = {"w": (rng.normal(size=(d, classes)) * 0.01).astype(np.float32),
              "b": np.zeros((classes,), np.float32)}
    for k, v in params.items():
        c.init(k, v)

    # each party's lead worker configures the global-tier optimizer (the
    # reference's DMLC_ROLE_MASTER_WORKER role, examples/cnn.py:92-96).
    # Every party sends it (idempotent server-side) because the barrier is
    # party-local: with only rank 0 configuring, another party's first
    # async-mode push could reach the global tier before the optimizer
    # command and be applied as a raw overwrite.  Within a party, FIFO
    # ordering on the relay socket puts the command before any push.
    # HFA runs the optimizer in the workers (params drift between syncs,
    # reference examples/cnn_hfa.py:108-134) — no server-side optimizer.
    if WORKER_ID == 0 and SYNC != "hfa":
        c.set_optimizer("sgd", learning_rate=LR)
    c.barrier()

    x_dev = torch.from_numpy(x).to(device)
    y_dev = torch.from_numpy(y).long().to(device)

    def grads(params, idx):
        # the gradients leave the device as numpy: frames carry numpy
        p = {k: torch.from_numpy(np.array(v)).to(device).requires_grad_()
             for k, v in params.items()}
        xb, yb = x_dev[idx], y_dev[idx]
        logits = xb @ p["w"] + p["b"]
        lse = torch.logsumexp(logits, dim=1)
        ll = logits[torch.arange(xb.shape[0], device=device), yb] - lse
        (-ll.mean()).backward()
        return {k: t.grad.detach().cpu().numpy() for k, t in p.items()}

    import time
    steps = len(x) // BATCH
    global_step = 0
    round_ms = []  # wall time of each push-and-pull exchange
    for ep in range(EPOCHS):
        perm = np.random.RandomState(ep).permutation(len(x))
        for s in range(steps):
            idx = perm[s * BATCH:(s + 1) * BATCH]
            g = grads(params, torch.from_numpy(idx).to(device))
            global_step += 1
            if SYNC == "hfa":
                # K1 local optimizer steps between local syncs; every K1
                # steps the party averages parameters through its server
                # (workers push params/num_local_workers, reference
                # cnn_hfa.py:119-134), and the server crosses the WAN every
                # K2 local syncs with the milestone delta
                for k in params:
                    params[k] = params[k] - LR * np.asarray(g[k])
                if global_step % HFA_K1 == 0:
                    t0 = time.perf_counter()
                    for pr, k in enumerate(sorted(params)):
                        c.push(k, params[k] / WORKERS_PER_PARTY,
                               priority=-pr)
                    for k in sorted(params):
                        params[k] = c.pull(k)
                    round_ms.append(1e3 * (time.perf_counter() - t0))
                continue
            if ENABLE_DGT:
                # DGT wire transport: contribution-ranked blocks, top-k
                # first at f32, the rest low-priority fp16
                t0 = time.perf_counter()
                for pr, k in enumerate(sorted(params)):
                    c.push_dgt(k, np.asarray(g[k]), priority=-pr)
                for k in sorted(params):
                    params[k] = c.pull(k)
                round_ms.append(1e3 * (time.perf_counter() - t0))
                continue
            if intra_ts:
                # announce partials to the ASK1 scheduler; the aggregate
                # reaches the server through the relay tree, and the fresh
                # value comes back via AutoPull dissemination
                t0 = time.perf_counter()
                for k in sorted(params):
                    c.ts_push(k, np.asarray(g[k]))
                for k in sorted(params):
                    params[k] = c.auto_pull(k, min_version=global_step)
                round_ms.append(1e3 * (time.perf_counter() - t0))
                continue
            # P3 discipline: front-layer keys get higher priority
            t0 = time.perf_counter()
            for pr, k in enumerate(sorted(params)):
                c.push(k, np.asarray(g[k]), priority=-pr)
            for k in sorted(params):
                params[k] = c.pull(k)
            round_ms.append(1e3 * (time.perf_counter() - t0))
        logits = x @ params["w"] + params["b"]
        acc = float((np.argmax(logits, 1) == y).mean())
        t_logits = xt @ params["w"] + params["b"]
        t_acc = float((np.argmax(t_logits, 1) == yt).mean())
        # NOTE: under HFA, non-milestone rounds pull the party-local
        # average, so per-party accuracies may disagree until the next K2
        # milestone sync (reference semantics)
        scope = " (party-local)" if SYNC == "hfa" else ""
        print(f"[worker p{PARTY_ID}w{WORKER_ID}] epoch {ep} "
              f"train_acc {acc:.3f} test_acc {t_acc:.3f}{scope}", flush=True)

    if SYNC == "hfa" and global_step % HFA_K1 != 0:
        # flush the drift accumulated since the last K1 boundary so every
        # worker finishes on the same synced model (all workers run the
        # same step count, so this extra round is symmetric)
        for pr, k in enumerate(sorted(params)):
            c.push(k, params[k] / WORKERS_PER_PARTY, priority=-pr)
        for k in sorted(params):
            params[k] = c.pull(k)

    save_dir = env("GEOMX_SAVE_PARAMS")
    if save_dir:
        # cross-plane verification hook (__graft_entry__ host-PS smoke):
        # the final pulled weights, for comparison against the SPMD run
        np.savez(os.path.join(save_dir,
                              f"worker_p{PARTY_ID}w{WORKER_ID}.npz"),
                 **params)

    save_stats(f"worker_p{PARTY_ID}w{WORKER_ID}", round_ms)
    c.barrier()
    # every worker sends kStopServer; the local server stops once all its
    # workers have, then forwards the stop up (reference
    # kvstore_dist_server.h:289-301 counts stop commands per tier)
    c.stop_server()
    c.close()
    if sc is not None:
        sc.close()


def main(argv=None):
    args = parse_args(argv)
    from geomx_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    {"scheduler": run_scheduler,
     "global_server": run_global_server,
     "server": run_local_server,
     "worker": run_worker}[ROLE](device)


if __name__ == "__main__":
    main()
