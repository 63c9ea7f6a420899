"""String-keyed backend registry + the ``make_index`` factory (port of
``repro.api.registry``)."""

from __future__ import annotations

from repro_torch.api.index import BackendSpec, Index, IndexSpec

_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(spec: BackendSpec, *, overwrite: bool = False) -> BackendSpec:
    """Install ``spec`` under ``spec.name``; re-registration must opt in."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def supported_maintenance(backend: str) -> tuple[str, ...]:
    """Maintenance policy *kinds* ``backend`` accepts via ``maintenance=``.

    ``("*",)`` expands to every kind the scheduler knows
    (``repro_torch.maintenance.KINDS``); literal entries pass through."""
    spec = get_backend(backend)
    if "*" not in spec.maintenance:
        return spec.maintenance
    from repro_torch.maintenance import KINDS

    literal = [m for m in spec.maintenance if m != "*"]
    return tuple(dict.fromkeys(literal + list(KINDS)))


def supported_engines(backend: str) -> tuple[str, ...]:
    """SearchEngine names ``backend`` accepts via ``engine=`` (a declared
    ``"*"`` expands to the engine registry at call time)."""
    spec = get_backend(backend)
    if "*" not in spec.engines:
        return spec.engines
    from repro_torch.core.engine import available_engines

    literal = [e for e in spec.engines if e != "*"]
    return tuple(dict.fromkeys(literal + available_engines()))


def make_index(backend: str = "deltatree", *, initial=None, payloads=None,
               engine: str | None = None, maintenance: str | None = None,
               device=None, **kwargs) -> Index:
    """Build an Index: ``backend`` picks the registry entry, ``initial``
    (unique keys) and ``payloads`` seed a bulk build (empty when None),
    ``engine`` selects the read-path SearchEngine ("scalar" / "lockstep";
    ``"auto"`` resolves first to the measured winner for this backend on
    ``device``'s type, `core.engine.resolve_engine`, and to "scalar" where
    the table has no row or its winner is one the backend cannot run),
    ``maintenance`` the scheduler policy, ``device`` where the state lives
    (``cuda`` when None; pass ``"cpu"`` to run on the CPU — with no card
    and no device this raises), and the remaining kwargs go to the
    backend's config (e.g. ``height=7`` or a prebuilt ``cfg=...``).
    """
    from repro_torch.maintenance import parse_policy

    spec = get_backend(backend)
    if engine == "auto":
        from repro_torch.core.deltatree import resolve_device
        from repro_torch.core.engine import resolve_engine

        engine = resolve_engine(engine, backend, resolve_device(device).type)
        if engine not in supported_engines(backend):
            engine = "scalar"  # table winner the backend can't run
    if engine is not None:
        engines = supported_engines(backend)
        if engine not in engines:
            raise ValueError(
                f"backend {backend!r} supports engines {engines}, "
                f"not {engine!r}")
        if spec.engines != ("scalar",):
            # engine-aware backends thread the name into their config;
            # single-engine backends just validated the default above
            kwargs["engine"] = engine
    if maintenance is not None:
        pol = parse_policy(maintenance)   # ValueError on garbage specs
        kinds = supported_maintenance(backend)
        if pol.kind not in kinds:
            raise ValueError(
                f"backend {backend!r} supports maintenance policies "
                f"{kinds}, not {maintenance!r}")
        if spec.maintenance != ("eager",):
            kwargs["maintenance"] = str(pol)
    cfg, state = spec.make(initial, payloads, device=device, **kwargs)
    ix = Index(IndexSpec(backend=spec, cfg=cfg), state)
    if ix.engine not in supported_engines(backend):
        raise ValueError(
            f"backend {backend!r} config names engine {ix.engine!r}; "
            f"supported: {supported_engines(backend)}")
    # the same early check for a policy carried in by a prebuilt cfg=
    ix_pol = parse_policy(ix.maintenance)
    if ix_pol.kind not in supported_maintenance(backend):
        raise ValueError(
            f"backend {backend!r} config names maintenance policy "
            f"{ix.maintenance!r}; supported kinds: "
            f"{supported_maintenance(backend)}")
    if payloads is not None and not ix.capability.map_mode:
        raise ValueError(
            f"backend {backend!r} with {ix.capability} stores no payloads; "
            f"drop payloads= or configure map mode (e.g. payload_bits > 0)")
    return ix
