"""perf/scaling.py harness — functional run on the virtual CPU mesh.

Timing on oversubscribed virtual devices is meaningless; these tests pin
that the harness drives the explicit shard_map steps over growing meshes
and that the report machinery is sound.
"""

import jax
import pytest

from cubez_tpu.perf import scaling


@pytest.mark.parametrize("solver", ["sor2sma", "pcr_rb", "jacobi"])
def test_weak_scaling_runs_production_paths(solver):
    if len(jax.devices()) < 2:
        pytest.skip("needs >=2 devices")
    pts = scaling.weak_scaling(
        block=16, solver=solver, omega=1.5 if solver != "jacobi" else 0.8,
        iters=2, device_counts=[1, 2],
    )
    assert [p.n_devices for p in pts] == [1, 2]
    for p in pts:
        assert p.seconds > 0 and p.cells_per_s > 0
    # 2-device point doubles the global grid along one axis
    assert sorted(pts[1].global_shape) != sorted(pts[0].global_shape)
    eff = scaling.efficiency(pts)
    assert len(eff) == 2 and eff[0] == 1.0
    rep = scaling.report(pts)
    assert "Mcells/s" in rep and len(rep.splitlines()) == 3
