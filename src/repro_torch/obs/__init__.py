"""Observability (port of ``repro.obs``): so far the trace-span shim."""
