"""What one ``torch.profiler`` session records of a profiled call on the
card, session after session in one process: the evidence behind
``utils/profiling.device_time_by_kernel``'s reading (the marks, and the
call's operations by correlation id).

    PYTHONPATH=. python tools/port_trace_probe.py [--paths dense schur packed]
        [--sessions 5] [--iters 5] [--poses 10000]

For each path, the chain of ``tools/port_trace_validate.py`` (dense and
schur on ``bench.load_graph``'s graph, packed on the default walk at
``--poses``) runs once unprofiled, then ``--sessions`` times through
``profiling._profile_once`` (the ``record_function`` range, the start
marks and the end mark around ``--iters`` steps), then once through
``device_time_by_kernel``.  One JSON line per session:

- ``launches``: the CUDA API calls in the host range that make a device
  record (kernel launches, copies, sets), the marks included;
- ``lost``: those with no device record in the session; ``lost_first`` the
  run of them at the start in correlation order, ``lost_last`` at the end;
- ``early_ms``: the most that a device record starts before its own
  launch on the profiler's timeline (a positive value: the two clocks
  disagree);
- ``late_ms``: the last device record's end after the host range's end;
- ``stray``: device records that no launch in the host range made.

Then one line of ``device_time_by_kernel``'s reading: ``n_ops``,
``n_ops_outside``, ``busy_ms``, ``span_ms``, ``window_ms``,
``host_window_ms``, ``sessions``.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

_MAKES_RECORD = ("Launch", "Memcpy", "Memset")


def session_record(events, window):
    """The line of one session (module docstring) from its ``events`` and
    host ``window`` (start, end) in us."""
    import torch

    from boslam_torch.utils.profiling import _RUNTIME

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    lo, hi = window
    launch = {e.id: e for e in events
              if e.device_type == cpu and _RUNTIME.match(e.name)
              and any(k in e.name for k in _MAKES_RECORD) and lo <= e.time_range.start <= hi}
    records = [e for e in events if e.device_type == cuda and e.id in launch]
    kept = sorted({e.id for e in records})
    order = sorted(launch)
    lost_first = order.index(kept[0]) if kept else len(order)
    lost_last = len(order) - 1 - order.index(kept[-1]) if kept else 0
    return {
        "launches": len(order),
        "lost": len(order) - len(kept),
        "lost_first": lost_first,
        "lost_last": lost_last,
        "early_ms": max(((launch[e.id].time_range.start - e.time_range.start) / 1e3
                         for e in records), default=None),
        "late_ms": (max(e.time_range.end for e in records) - hi) / 1e3 if records else None,
        "stray": sum(e.device_type == cuda and e.id not in launch for e in events),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--paths", nargs="+", choices=["dense", "schur", "packed"],
                    default=["dense", "schur", "packed"])
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--poses", type=int, default=10_000)
    args = ap.parse_args(argv)
    logging.disable(logging.WARNING)

    import torch

    if not torch.cuda.is_available():
        print("port_trace_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import port_trace_validate as tv

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.bench import load_graph
    from boslam_torch.graph.build import build_graph
    from boslam_torch.utils import profiling

    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    ref = build_graph(load_graph(None)[0], init="triangulate", device=dev)[0]
    for name in args.paths:
        chain = tv.Chain(name, tv.walk_graph(args.poses, dev) if name == "packed" else ref)
        chain.run(1)
        profiling.sync(dev)
        for k in range(args.sessions):
            events, _ = profiling._profile_once(lambda: chain.run(args.iters), dev)
            _, window = profiling._device_ops(events, True)
            rec = session_record(events, window) if window is not None else {"window": None}
            print(f"probe {name} session {k}: " + json.dumps(rec), flush=True)
        tr = profiling.device_time_by_kernel(lambda: chain.run(args.iters), dev)
        print(f"probe {name} reading: " + json.dumps(dict(
            n_ops=tr.n_ops, n_ops_outside=tr.n_ops_outside, busy_ms=tr.busy_ms,
            span_ms=tr.span_ms, window_ms=tr.window_ms, host_window_ms=tr.host_window_ms,
            sessions=tr.sessions)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
