"""Observability (port of ``repro.obs``): so far the trace-span shim
(`trace`) and the serve loop's ``ServeStats`` / ``ScanStats`` (`stats`)."""
