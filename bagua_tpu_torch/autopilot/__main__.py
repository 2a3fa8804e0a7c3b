"""Operator CLI: replay a fleet snapshot stream against the current
policy matrix.

    python -m bagua_tpu_torch.autopilot --replay SNAPSHOTS.jsonl
        [--out DECISIONS.json] [--expect PLAN.json]
        [--slo-goodput F] [--sustain N] [--cooldown-s S] [--budget N]
        [--staleness-s S] [--straggler-ratio F] [--ckpt-failures N]
        [--family NAME] [--historian] [--trend-window-s S]
        [--dcn-share F] [--hbm-horizon-s S] [--compress-family NAME]

``SNAPSHOTS.jsonl``: one ``bagua-obs-fleet-v1`` record per line (the
stream a coordinator's ``BAGUA_OBS_FLEET_OUT`` writer produced — tail the
file into a log, or synthesize one).  Replay is a pure rehearsal: each
snapshot is evaluated at its OWN ``time_unix`` (deterministic regardless
of when the operator runs it) and nothing actuates.  Prints the decision
log as JSON; ``--expect`` compares the decided action plan (the
``(snapshot, kind, rule)`` sequence) against a committed expectation and
exits non-zero on mismatch — the CI smoke gate.

Policy knobs default to the ``BAGUA_AUTOPILOT_*`` env registry values;
flags override (so an operator can ask "what WOULD a tighter SLO have
done to yesterday's fleet?").

``--historian`` replays the stream through a fresh telemetry historian
(:mod:`bagua_tpu_torch.obs.historian`) first — each snapshot is ingested and
trend-augmented exactly as the live coordinator would, so the trend
rules (pre-OOM resize on shrinking HBM headroom, DCN-dominance
compression hint) can fire.  Deterministic: historian samples are
timestamped by the records' own ``time_unix``.  Also on when
``BAGUA_OBS_HISTORIAN=on``; raw (un-augmented) replays of streams whose
snapshots already carry ``trends`` behave identically either way.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from typing import List

from .. import env as _env
from .engine import replay
from .policy import config_from_env


def _load_snapshots(path: str) -> List[dict]:
    snaps = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                snaps.append(json.loads(line))
            except ValueError as e:
                sys.exit(f"{path}:{i + 1}: unparseable snapshot: {e}")
    if not snaps:
        sys.exit(f"{path}: no snapshots")
    return snaps


def _plan(log: List[dict]) -> List[dict]:
    """The comparable skeleton of a decision log: which action kinds which
    rules decided at which snapshot (targets/reasons carry wall-clock and
    host specifics that must not fail a replay gate)."""
    return [
        {"snapshot": entry["snapshot"], "kind": a["kind"], "rule": a["rule"]}
        for entry in log for a in entry["actions"]
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "python -m bagua_tpu_torch.autopilot",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--replay", required=True, metavar="SNAPSHOTS.jsonl",
                    help="fleet snapshot stream (one JSON record per line)")
    ap.add_argument("--out", default=None,
                    help="write the full decision log here (default: stdout)")
    ap.add_argument("--expect", default=None, metavar="PLAN.json",
                    help="committed expected action plan; exit 1 on "
                         "mismatch (the CI smoke gate)")
    ap.add_argument("--slo-goodput", type=float, default=None)
    ap.add_argument("--sustain", type=int, default=None)
    ap.add_argument("--cooldown-s", type=float, default=None)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--staleness-s", type=float, default=None)
    ap.add_argument("--straggler-ratio", type=float, default=None)
    ap.add_argument("--suspect-ttl-s", type=float, default=None)
    ap.add_argument("--ckpt-failures", type=int, default=None)
    ap.add_argument("--family", default=None)
    ap.add_argument("--dcn-share", type=float, default=None)
    ap.add_argument("--hbm-horizon-s", type=float, default=None)
    ap.add_argument("--compress-family", default=None)
    ap.add_argument("--compress-codec", default=None)
    ap.add_argument("--historian", action="store_true",
                    help="ingest the stream through a fresh telemetry "
                         "historian first (trend-augmented snapshots, as "
                         "the live coordinator would see them) — required "
                         "for the hbm_exhaustion/dcn_dominance rules; "
                         "also on when BAGUA_OBS_HISTORIAN=on")
    ap.add_argument("--trend-window-s", type=float, default=None,
                    help="historian trend window override "
                         "(default BAGUA_OBS_HISTORIAN_WINDOW_S)")
    args = ap.parse_args(argv)

    config = config_from_env()
    overrides = {
        "slo_goodput": args.slo_goodput, "sustain": args.sustain,
        "cooldown_s": args.cooldown_s, "budget": args.budget,
        "staleness_s": args.staleness_s,
        "straggler_ratio": args.straggler_ratio,
        "suspect_ttl_s": args.suspect_ttl_s,
        "ckpt_failures": args.ckpt_failures, "switch_family": args.family,
        "dcn_share": args.dcn_share, "hbm_horizon_s": args.hbm_horizon_s,
        "compress_family": args.compress_family,
        "compress_codec": args.compress_codec,
    }
    config = replace(config, mode="observe",
                     **{k: v for k, v in overrides.items() if v is not None})

    historian = None
    if args.historian or _env.is_obs_historian_on():
        from ..obs.historian import Historian

        historian = Historian(window_s=args.trend_window_s)

    log = replay(_load_snapshots(args.replay), config, historian=historian)
    record = {
        "mode": "replay",
        "historian": historian is not None,
        "config": {k: getattr(config, k)
                   for k in config.__dataclass_fields__},
        "decisions": log,
        "plan": _plan(log),
    }
    text = json.dumps(record, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out} ({len(record['plan'])} action(s) over "
              f"{len(log)} snapshot(s))")
    else:
        print(text)

    if args.expect:
        expected = json.load(open(args.expect))
        if isinstance(expected, dict):
            expected = expected.get("plan", expected)
        if record["plan"] != expected:
            print("autopilot replay: action plan DIVERGED from expectation",
                  file=sys.stderr)
            print(f"  expected: {json.dumps(expected)}", file=sys.stderr)
            print(f"  got:      {json.dumps(record['plan'])}",
                  file=sys.stderr)
            return 1
        print(f"autopilot replay: plan matches {args.expect} "
              f"({len(expected)} action(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
