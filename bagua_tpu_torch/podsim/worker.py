"""One simulated node of the pod: real membership, real lease, shaped
data plane.

Port of ``bagua_tpu/podsim/worker.py``.  Executed as a *file* (``python
.../podsim/worker.py``), not ``-m``: the bootstrap below
(:mod:`~bagua_tpu_torch.podsim._bootstrap`) installs namespace packages for
``bagua_tpu_torch`` and its ``contrib`` and ``elastic`` subpackages, so the
node imports only the store, elastic and podsim modules and loads neither
torch nor anything of the JAX package: a 32-rank drill cannot afford 32
torch imports (seconds each on a loaded host).

Per epoch the worker walks the member path end to end: ``join_round`` ->
:class:`LeaseHeartbeat` (its own store connection, the health payload from
the node's *profile*) -> the shaped hierarchical and compressed data plane
(:mod:`~bagua_tpu_torch.podsim.collectives` over
:class:`~bagua_tpu_torch.podsim.transport.RingTransport`) -> watching for
the stop and halt fences.  Profiles are switched live through the store key
``podsim/profile/<node>``, so the orchestrator can turn a healthy node into
a chronic straggler mid-run and watch the autopilot fence it:

========== ==========================================================
profile    heartbeat health payload
========== ==========================================================
healthy    goodput ~0.92, no suspects
straggler  dispatch-dominant ``straggler_suspect`` (ratio 6): the
           autopilot's ``chronic_straggler`` rule fences the node
slow       goodput 0.3: drags the fleet SLO minimum
========== ==========================================================

Exit codes mirror the launcher: 0 done or halted, 4 fenced, 3 error.
"""

import sys
import time

#: when this module started to run: the node's import seconds are measured
#: from here to the end of its imports (the bootstrap's effect)
_T_START = time.monotonic()

if __package__ in (None, ""):  # pragma: no cover - subprocess entry
    import os

    import _bootstrap

    _bootstrap.install(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402

from bagua_tpu_torch.contrib.utils.tcp_store import TCPStore  # noqa: E402
from bagua_tpu_torch.elastic.coordinator import (  # noqa: E402
    ExcludedFromRound,
    Halted,
    join_round,
    wait_for_next_epoch,
)
from bagua_tpu_torch.elastic.membership import (  # noqa: E402
    LeaseHeartbeat,
    MembershipClient,
    WorldSpec,
)
from bagua_tpu_torch.podsim.shaping import LinkShaper, resolve_shape  # noqa: E402
from bagua_tpu_torch.podsim.transport import RingTransport  # noqa: E402

logger = logging.getLogger("podsim.worker")

#: seconds from the first line of this module to the end of its imports
IMPORT_S = time.monotonic() - _T_START

PROFILE_KEY = "podsim/profile/{node}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store-addr", default="127.0.0.1")
    ap.add_argument("--store-port", type=int, required=True)
    ap.add_argument("--store-endpoints", default="",
                    help="comma-separated host:port replica group; when "
                         "set, every store client this worker opens is a "
                         "FailoverStore over the group — ops survive the "
                         "primary store dying mid-epoch (the coordinator-"
                         "failover drill)")
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--max-nnodes", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="shaped collective steps per epoch (0 = none)")
    ap.add_argument("--vec-elems", type=int, default=16384)
    ap.add_argument("--shape", default="pod",
                    help="link shape preset name or JSON object")
    ap.add_argument("--slice-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dcn-codec", default="minmax_uint8",
                    choices=("minmax_uint8", "f32", "onebit_ef", "topk"))
    ap.add_argument("--hb-interval", type=float, default=0.5)
    ap.add_argument("--timeout", type=float, default=120.0)
    return ap.parse_args(argv)


def _connect_store(args, timeout_s: float = 30.0):
    if args.store_endpoints:
        from bagua_tpu_torch.elastic.failover import FailoverStore

        return FailoverStore(
            [e.strip() for e in args.store_endpoints.split(",")
             if e.strip()],
            connect_timeout_s=timeout_s,
        )
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return TCPStore(args.store_addr, args.store_port, timeout_s=60.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _health(args, state: dict):
    """The heartbeat's health payload for the node's current profile.
    Single-rank obs form — ``build_fleet_record`` normalizes it."""
    profile = state.get("profile", "healthy")
    obs = {
        "rank": args.node_id,
        "step": int(state.get("steps_done", 0)),
        "goodput_fraction": 0.92,
        "worst_badput_class": "collective_wait",
    }
    if profile == "straggler":
        obs["straggler_suspect"] = {
            "rank": args.node_id,
            "ratio": 6.0,
            "detected_at_unix": time.time(),
            "dominant_phase": "dispatch",
        }
    elif profile == "slow":
        obs["goodput_fraction"] = 0.3
    return {"obs": obs}


def _rss_mb() -> float:
    """This process's resident set now, in MiB (``VmRSS``; 0 where /proc has
    none).  Not ``ru_maxrss``, which keeps the parent's peak across the exec,
    nor ``VmHWM``, which the H100 host's kernel was seen to report in
    gigabytes for a node of tens of megabytes."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 2)
    except OSError:
        pass
    return 0.0


def _poll_profile(store, args, state: dict) -> None:
    raw = store.get(PROFILE_KEY.format(node=args.node_id))
    if raw is not None:
        state["profile"] = raw.decode()


def _hier_geometry(world: int, slice_size: int):
    """(intra, inter): hierarchical when the slice width divides the
    world evenly, flat single ring otherwise (a post-shrink ragged world
    still runs shaped collectives, just unhierarchically)."""
    if slice_size > 1 and world % slice_size == 0 and world > slice_size:
        return slice_size, world // slice_size
    return world, 1


def _data_plane(args, store, spec: WorldSpec, state: dict) -> dict:
    from bagua_tpu_torch.podsim import collectives as C

    import numpy as np

    rank = spec.rank_of(args.node_id)
    world = spec.nnodes
    intra, inter = _hier_geometry(world, args.slice_size)
    shape = resolve_shape(args.shape, slice_size=args.slice_size,
                          seed=args.seed)
    shaper = LinkShaper(shape, world)
    slice_idx, pos_in_slice = rank // intra, rank % intra
    ns = f"podsim/{spec.epoch}/ring"
    intra_ring = RingTransport(
        store, f"{ns}/intra{slice_idx}",
        [slice_idx * intra + j for j in range(intra)], pos_in_slice,
        shaper=shaper, timeout_s=args.timeout,
    )
    inter_ring = RingTransport(
        store, f"{ns}/inter{pos_in_slice}",
        [pos_in_slice + s * intra for s in range(inter)], slice_idx,
        shaper=shaper, timeout_s=args.timeout,
    ) if inter > 1 else None

    # every rank regenerates every rank's vector -> exact expected mean
    n = args.vec_elems
    vecs = [
        np.random.default_rng([args.seed, spec.epoch, r]).uniform(
            -1.0, 1.0, n).astype(np.float32)
        for r in range(world)
    ]
    expected = np.mean(vecs, axis=0)
    atol = (C.quantization_atol(2.0 * intra, 2 * max(1, inter - 1),
                                args.dcn_codec)
            if args.dcn_codec != "f32" and inter > 1 else 1e-4)

    max_err, t0 = 0.0, time.monotonic()
    try:
        for step in range(args.steps):
            out, hops = C.hierarchical_allreduce(
                vecs[rank],
                intra_ring.hop, pos_in_slice, intra,
                (inter_ring.hop if inter_ring is not None
                 else intra_ring.hop), slice_idx, inter,
                dcn_codec=args.dcn_codec,
            )
            err = float(np.max(np.abs(out - expected)))
            max_err = max(max_err, err)
            if err > atol:
                raise AssertionError(
                    f"step {step}: allreduce error {err:.5f} > atol "
                    f"{atol:.5f} (world {world}, {intra}x{inter})"
                )
            state["steps_done"] = step + 1
            _poll_profile(store, args, state)
    finally:
        intra_ring.close()
        if inter_ring is not None:
            inter_ring.close()
    return {
        "rank": rank, "world": world, "intra": intra, "inter": inter,
        "steps": args.steps, "max_err": max_err, "atol": atol,
        "wall_s": round(time.monotonic() - t0, 3),
        "shaping": shaper.stats,
    }


def _run_epoch(args, store, client: MembershipClient,
               spec: WorldSpec, state: dict) -> str:
    hb = LeaseHeartbeat(
        # failover mode: the heartbeat's own connection must also walk the
        # endpoint list, or a dead primary silently kills every lease
        (lambda: _connect_store(args))
        if args.store_endpoints else
        (lambda: TCPStore(args.store_addr, args.store_port, timeout_s=30.0)),
        args.node_id, spec.epoch, interval_s=args.hb_interval,
        max_nnodes=args.max_nnodes,
        health_source=lambda: _health(args, state),
    ).start()
    try:
        if args.steps > 0 and spec.nnodes > 1:
            verdict = _data_plane(args, store, spec, state)
        else:
            verdict = {"rank": spec.rank_of(args.node_id),
                       "world": spec.nnodes, "skipped": True}
        # the node's own cost (torch-free bootstrap): import seconds and its
        # largest resident-set reading (after the imports, after the data
        # plane, which holds every rank's vector)
        verdict["import_s"] = round(IMPORT_S, 4)
        state["rss_mb"] = max(state.get("rss_mb", 0.0), _rss_mb())
        verdict["peak_rss_mb"] = state["rss_mb"]
        store.set(f"podsim/{spec.epoch}/ok/{args.node_id}",
                  json.dumps(verdict))
        print(f"node {args.node_id}: epoch {spec.epoch} ok "
              f"(world {spec.nnodes}, rank {spec.rank_of(args.node_id)})",
              flush=True)
        while True:
            if client.read_halt() is not None:
                return "halt"
            stop = client.read_stop(spec.epoch)
            if stop is not None:
                if not stop.get("rejoin", True) and \
                        args.node_id in (stop.get("nodes") or []):
                    print(f"node {args.node_id}: fenced "
                          f"({stop.get('kind')})", flush=True)
                    return "fenced"
                return "stop"
            cur = client.current_epoch()
            if cur is not None and cur > spec.epoch:
                return "stop"
            _poll_profile(store, args, state)
            time.sleep(0.2)
    finally:
        hb.stop()


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    args = parse_args(argv)
    store = _connect_store(args)
    client = MembershipClient(store, args.node_id, args.max_nnodes)
    state = {"profile": "healthy", "steps_done": 0, "rss_mb": _rss_mb()}
    _poll_profile(store, args, state)

    deadline = time.monotonic() + args.timeout
    epoch = None
    while epoch is None:
        epoch = client.current_epoch()
        if epoch is None:
            if time.monotonic() > deadline:
                print(f"node {args.node_id}: no epoch opened", flush=True)
                return 3
            time.sleep(0.1)

    # scale the rendezvous poll with fleet size: 128 members polling every
    # 0.2 s is 1.3k store round-trips/s of pure waiting, which starves the
    # very joins being waited on (single-core CI, threaded Python store)
    poll_s = min(1.0, max(0.2, args.max_nnodes / 128.0))
    while True:
        try:
            spec = join_round(client, epoch, timeout_s=args.timeout,
                              poll_s=poll_s)
        except ExcludedFromRound as e:
            print(f"node {args.node_id}: excluded from epoch {e.spec.epoch};"
                  " standing by", flush=True)
            try:
                epoch = wait_for_next_epoch(client, e.spec.epoch,
                                            timeout_s=args.timeout,
                                            poll_s=poll_s)
            except Halted:
                return 0
            continue
        except Halted:
            return 0
        print(f"node {args.node_id}: joined epoch {spec.epoch} "
              f"world {spec.nnodes}", flush=True)
        rc = _run_epoch(args, store, client, spec, state)
        if rc == "halt":
            return 0
        if rc == "fenced":
            return 4
        try:
            epoch = wait_for_next_epoch(client, spec.epoch,
                                        timeout_s=args.timeout,
                                        poll_s=poll_s)
        except Halted:
            return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - drill log must carry the cause
        import traceback

        traceback.print_exc()
        sys.exit(3)
