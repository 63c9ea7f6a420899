"""Dry-run analysis (port of ``repro.analysis``): `count` (what a step
costs, counted from its ops), `roofline` (H100 terms) and `report`
(the dry-run's tables, stdlib only)."""
