"""TridentServe core, as ported so far: requests, placement types, the
profiler's cost model on a named hardware set, the ILP solver, the Dynamic
Orchestrator and the Resource-Aware Dispatcher. Counterpart of
``repro/core``; the simulator, runtime, fleet and the rest wait."""
