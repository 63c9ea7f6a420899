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
    ``engine`` selects the read-path SearchEngine ("scalar" / "lockstep"),
    ``maintenance`` the scheduler policy, ``device`` where the state lives
    (``cuda`` when None; pass ``"cpu"`` to run on the CPU — with no card
    and no device this raises), and the remaining kwargs go to the
    backend's config (e.g. ``height=7`` or a prebuilt ``cfg=...``).

    ``engine="auto"`` raises: the JAX package's table behind it was
    measured on a TPU and on CPUs, and the port gets its own only from
    H100 measurements.
    """
    from repro_torch.maintenance import parse_policy

    spec = get_backend(backend)
    if engine == "auto":
        raise NotImplementedError(
            "engine='auto' has no H100 table yet; pass 'lockstep' or "
            "'scalar' (see ROADMAP.md)")
    if engine is not None:
        engines = supported_engines(backend)
        if engine not in engines:
            raise ValueError(
                f"backend {backend!r} supports engines {engines}, "
                f"not {engine!r}")
        kwargs["engine"] = engine
    if maintenance is not None:
        pol = parse_policy(maintenance)   # ValueError on garbage specs
        if pol.kind not in spec.maintenance:
            raise ValueError(
                f"backend {backend!r} supports maintenance policies "
                f"{spec.maintenance}, not {maintenance!r}")
        kwargs["maintenance"] = str(pol)
    cfg, state = spec.make(initial, payloads, device=device, **kwargs)
    ix = Index(IndexSpec(backend=spec, cfg=cfg), state)
    if ix.engine not in supported_engines(backend):
        raise ValueError(
            f"backend {backend!r} config names engine {ix.engine!r}; "
            f"supported: {supported_engines(backend)}")
    if payloads is not None and not ix.capability.map_mode:
        raise ValueError(
            f"backend {backend!r} with {ix.capability} stores no payloads; "
            f"drop payloads= or configure map mode (e.g. payload_bits > 0)")
    return ix
