"""Process-per-role launcher for the PS plane — the tracker (port of
scripts/launch.py).

Reference analogue: the dmlc job trackers (3rdparty/ps-lite/tracker/
dmlc_local.py and dmlc_ssh.py; also 3rdparty/dmlc-core/tracker/): spawn
one OS process per node role with the topology described entirely by
environment variables, locally or over ssh.

Local (all roles on this machine, like dmlc_local.py):

    python -m geomx_tpu_torch.launch --num-parties 2 --workers-per-party 2 \\
        -- python -m geomx_tpu_torch.examples.dist_ps -c

Multi-host over ssh (like dmlc_ssh.py): a hostfile with one host per
line; the first host runs the global server, parties are assigned
round-robin over the remaining hosts (their server and workers
co-located, so only the cross-party hop crosses hosts — the WAN hop):

    python -m geomx_tpu_torch.launch --hostfile hosts.txt \\
        --num-parties 2 --workers-per-party 2 \\
        -- python -m geomx_tpu_torch.examples.dist_ps

Role/coordinate env vars set per process: GEOMX_ROLE, GEOMX_PARTY_ID,
GEOMX_WORKER_ID, GEOMX_PS_GLOBAL_HOST, GEOMX_PS_HOST (see
docs/env-var-summary.md).  All GEOMX_*/PS_*/DMLC_* vars already in the
launcher's environment are forwarded to every process, so e.g.
GEOMX_COMPRESSION / PS_RESEND set here apply cluster-wide.

Exit status is non-zero if any process fails; servers shut themselves
down after every worker sends kStopServer, and are killed on launcher
exit as a backstop.  The last line on stderr lists every process's exit
code (``[launch] exit codes {...}``).  Processes start with the
launcher's working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import time

FORWARD_PREFIXES = ("GEOMX_", "PS_", "DMLC_", "MXNET_", "CUDA_",
                    "TORCH_")


def forwarded_env():
    return {k: v for k, v in os.environ.items()
            if k.startswith(FORWARD_PREFIXES)}


def is_local(host):
    return host in (None, "localhost", "127.0.0.1")


def build_cmd(cmd, env, host, launch_id):
    """Local: run cmd with env. Remote: ssh host, recording the remote pid
    to /tmp/<launch_id>.pids before exec'ing the program, so cleanup can
    kill the actual python process (an `env ... python` cmdline carries no
    tag pkill could match after exec)."""
    if is_local(host):
        full_env = dict(os.environ)
        full_env.update(env)
        return cmd, full_env
    # the launcher's interpreter is a local absolute path (venvs!) that
    # need not exist on the remote host — translate it to bare python3
    if cmd and cmd[0] == sys.executable:
        cmd = ["python3"] + cmd[1:]
    assigns = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    remote = (f"cd {shlex.quote(os.getcwd())} && "
              f"echo $$ >> /tmp/{launch_id}.pids && "
              f"exec env {assigns} {' '.join(shlex.quote(c) for c in cmd)}")
    return ["ssh", "-o", "StrictHostKeyChecking=no", host, remote], None


def spawn(cmd, env, host, tag, launch_id):
    argv, full_env = build_cmd(cmd, env, host, launch_id)
    p = subprocess.Popen(argv, env=full_env)
    p._geomx_tag = tag  # for reporting
    return p


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-parties", type=int,
                    default=int(os.environ.get("GEOMX_NUM_PARTIES", 2)))
    ap.add_argument("--workers-per-party", type=int,
                    default=int(os.environ.get("GEOMX_WORKERS_PER_PARTY", 2)))
    ap.add_argument("--hostfile", default=None,
                    help="one host per line; omit for all-local")
    ap.add_argument("--num-global-servers", type=int,
                    default=int(os.environ.get("GEOMX_NUM_GLOBAL_SERVERS", 1)),
                    help="MultiGPS: N global PS processes at "
                         "global-port..global-port+N-1")
    ap.add_argument("--global-port", type=int,
                    default=int(os.environ.get("GEOMX_PS_GLOBAL_PORT", 19700)))
    ap.add_argument("--local-port", type=int,
                    default=int(os.environ.get("GEOMX_PS_PORT", 19800)))
    ap.add_argument("--server-start-delay", type=float, default=1.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- worker program and args (default: "
                         "python -m geomx_tpu_torch.examples.dist_ps)")
    args = ap.parse_args()

    hosts = [None]
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = [h for h in (ln.strip() for ln in f)
                     if h and not h.startswith("#")]
        if not hosts:
            ap.error("empty hostfile")

    global_host = hosts[0]
    party_hosts = hosts[1:] or hosts
    multi_host = not all(is_local(h) for h in hosts)
    launch_id = f"geomx-launch-{os.getpid()}-{int(time.time())}"

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        # build_cmd translates this to bare python3 for remote hosts
        cmd = [sys.executable, "-m", "geomx_tpu_torch.examples.dist_ps"]
    base = forwarded_env()
    base.update({
        "GEOMX_NUM_PARTIES": str(args.num_parties),
        "GEOMX_WORKERS_PER_PARTY": str(args.workers_per_party),
        "GEOMX_PS_GLOBAL_PORT": str(args.global_port),
        "GEOMX_PS_PORT": str(args.local_port),
        "GEOMX_PS_GLOBAL_HOST": global_host or "127.0.0.1",
        "GEOMX_NUM_GLOBAL_SERVERS": str(args.num_global_servers),
        # tag every process so remote cleanup can pkill by launch id
        "GEOMX_LAUNCH_ID": launch_id,
    })
    if multi_host:
        # servers must accept cross-host connections, not just loopback
        base["GEOMX_PS_BIND_HOST"] = "0.0.0.0"

    procs, workers = [], []
    use_sched = os.environ.get("GEOMX_USE_SCHEDULER", "0") not in ("0", "")
    try:
        if use_sched:
            env = dict(base, GEOMX_ROLE="scheduler")
            procs.append(spawn(cmd, env, global_host, "scheduler",
                               launch_id))
        for g in range(args.num_global_servers):
            env = dict(base, GEOMX_ROLE="global_server", GEOMX_GS_ID=str(g))
            procs.append(spawn(cmd, env, global_host, f"global_server:{g}",
                               launch_id))
        time.sleep(args.server_start_delay)

        for p in range(args.num_parties):
            host = party_hosts[p % len(party_hosts)]
            # GEOMX_PS_HOST doubles as the server's advertised address
            # when scheduler discovery is on
            env = dict(base, GEOMX_ROLE="server", GEOMX_PARTY_ID=str(p),
                       GEOMX_PS_HOST=host or "127.0.0.1")
            procs.append(spawn(cmd, env, host, f"server:p{p}", launch_id))
        time.sleep(args.server_start_delay)
        # note: start ordering is best-effort; the service layer's
        # connect_retry (protocol.py) absorbs slow tier bring-up

        for p in range(args.num_parties):
            host = party_hosts[p % len(party_hosts)]
            # workers connect to their party server: same host
            for w in range(args.workers_per_party):
                env = dict(base, GEOMX_ROLE="worker",
                           GEOMX_PARTY_ID=str(p), GEOMX_WORKER_ID=str(w),
                           GEOMX_PS_HOST=host or "127.0.0.1")
                workers.append(
                    spawn(cmd, env, host, f"worker:p{p}w{w}", launch_id))

        # fail fast: one dead worker means the sync barriers can never
        # complete, so tear the job down instead of hanging forever
        status = 0
        pending = list(workers)
        while pending and status == 0:
            time.sleep(0.2)
            still = []
            for w in pending:
                rc = w.poll()
                if rc is None:
                    still.append(w)
                elif rc != 0:
                    print(f"[launch] {w._geomx_tag} exited {rc} — "
                          "aborting the job", file=sys.stderr)
                    status = 1
            pending = still
        if status == 0:
            # servers exit on their own after all kStopServer commands
            deadline = time.time() + 30
            for s in procs:
                timeout = max(0.1, deadline - time.time())
                try:
                    s.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    print(f"[launch] killing {s._geomx_tag} (no clean stop)",
                          file=sys.stderr)
                    s.kill()
                    s.wait()
                    status = status or 1
                if s.returncode != 0:
                    status = status or 1
        return status
    finally:
        for p in procs + workers:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        for p in procs + workers:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        print("[launch] exit codes "
              + json.dumps({p._geomx_tag: p.returncode
                            for p in procs + workers}),
              file=sys.stderr, flush=True)
        # SIGTERM above only reaches the local ssh clients; kill the remote
        # processes by the pids each one recorded before exec'ing
        pidfile = f"/tmp/{launch_id}.pids"
        for host in {h for h in hosts if not is_local(h)}:
            subprocess.run(
                ["ssh", "-o", "StrictHostKeyChecking=no", host,
                 f"[ -f {pidfile} ] && kill $(cat {pidfile}) 2>/dev/null; "
                 f"rm -f {pidfile}; true"],
                timeout=20, check=False)


if __name__ == "__main__":
    sys.exit(main())
