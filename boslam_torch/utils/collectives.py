"""Collective accounting by run-time count (counterpart of
``boslam/utils/hlo.py``).

The JAX module compiles a function and sums the result-shape bytes of
every collective instruction in XLA's optimized HLO.  The port has no
compiled program to read: each collective of ``parallel/mesh.Mesh`` adds
the bytes of its result to ``Mesh.bytes`` as it runs, and
``collective_bytes`` runs a function once and reads those counters under
the HLO kinds' names:

    psum, pmax     -> all-reduce
    all_gather     -> all-gather
    psum_scatter   -> reduce-scatter
    (none)         -> collective-permute (the port's layouts make none)

The one difference: JAX counts each instruction of the compiled program
once, so a loop body counts once, however often it runs; the port counts
each call made at run time.  A caller that wants bytes per iteration
passes the loop body, as ``tools/mesh_scaling_bench.py:_hlo_collectives``
does.  ``count`` is the number of calls; XLA's all-reduce combiner may
merge instructions that the port issues as separate calls, so counts need
not agree where bytes do.

``collective_instruction_bytes`` (the HLO text parser) has no counterpart:
a program without XLA never produces HLO text.
"""

from __future__ import annotations

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")
_KIND = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
         "psum_scatter": "reduce-scatter"}


def collective_bytes(fn, *args, mesh, **kwargs) -> dict:
    """Run ``fn(*args, mesh=mesh, **kwargs)`` once on this rank and account
    the collectives it made on ``mesh``.  Returns ``{"all-reduce": bytes, ...,
    "count": n, "total": bytes}``, the keys of the JAX function.  The
    mesh's counters are reset first and hold this run's counts after."""
    mesh.reset_counts()
    fn(*args, mesh=mesh, **kwargs)
    rec = dict.fromkeys(COLLECTIVES, 0)
    rec["count"] = 0
    for kind, hlo_kind in _KIND.items():
        rec[hlo_kind] += mesh.bytes[kind]
        rec["count"] += mesh.calls[kind]
    rec["total"] = sum(rec[k] for k in COLLECTIVES)
    return rec
