"""The paper's benchmark scripts on the ported core, file by file beside
the JAX package's ``benchmarks/``: one module per table or figure, each with
``run(quick, hw) -> rows`` on the profiler's named constant set
(``core/profiler.HARDWARE``), and the harness ``run.py``."""
