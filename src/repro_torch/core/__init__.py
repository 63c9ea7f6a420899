"""ΔTree core: the vEB layout tables, the tree itself, its read engines and
the set/map oracles (port of ``repro.core``)."""
