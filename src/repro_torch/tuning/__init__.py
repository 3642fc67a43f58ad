"""Backend routing for the engine: cost model and cached autotuner (port
of ``repro.tuning``).

``impl="auto"``  -> :func:`repro_torch.tuning.costmodel.choose_plan`, pure
arithmetic over an analytical per-hop cost model, safe on the hot path.
``impl="tuned"`` -> :func:`repro_torch.tuning.autotune.autotune`, which
times a cost-model shortlist on the actual model and batch shape and
caches the winner per (shape, device fingerprint).

Every plan is an execution choice only: all backends are bit-identical
(docs/PARITY.md), so routing can change speed, never verdicts.  The JAX
package's ``BLOCK_B_CANDIDATES`` has no counterpart: no backend of the
port has a SID-block size to tune.

``python -m repro_torch.tuning --device cpu|cuda`` fits a coefficient
row of ``DEFAULT_COEFFS`` (see ``costmodel``).
"""
from repro_torch.tuning.autotune import (  # noqa: F401
    autotune,
    cache_path,
    device_fingerprint,
    get_plan,
    load_cache,
    resolve_route,
    save_cache,
    time_plan,
)
from repro_torch.tuning.costmodel import (  # noqa: F401
    BACKENDS,
    TICK_ENGINES,
    Coefficients,
    Plan,
    ShapeInfo,
    calibrate,
    candidate_plans,
    choose_plan,
    choose_tick_engine,
    choose_tick_plan,
    estimate_tick_us,
    estimate_us,
    fit_coefficients,
    tick_work_terms,
    work_terms,
)
