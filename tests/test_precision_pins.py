"""Contractions pinned to ``Precision.HIGHEST``.

On the GPU a float32 matmul at default precision may run in TF32 (10-bit
mantissa).  ``chip_smoke.py``'s precision phase measured which ops that
breaks; each of them pins every ``dot_general`` it traces, and these tests
read the pin from the jaxpr, so they hold on the CPU too."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from visual_sgraphs.core import lie
from visual_sgraphs.slam.tracking import pose_only_gn


def _dots(jaxpr) -> list:
    """(precision, operand shapes) of every dot_general in ``jaxpr`` and in
    the jaxprs nested in its equations (scan, cond, pjit bodies)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"],
                        [v.aval.shape for v in eqn.invars]))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    out += _dots(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    out += _dots(sub)
    return out


def _unpinned(fn, *args, size: int) -> tuple[int, list]:
    """(number of dot_generals with an operand dimension of ``size``, the
    precisions among them that are not HIGHEST)."""
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    highest = jax.lax.Precision.HIGHEST
    hits = [p for p, shapes in _dots(jaxpr)
            if any(size in s for s in shapes)]
    return len(hits), [p for p in hits
                       if p is None or any(q != highest for q in p)]


def _pose_problem(m=32, seed=0):
    rng = np.random.default_rng(seed)
    xw = jnp.asarray(rng.uniform([-2, -1, 2], [2, 1, 5], (m, 3)),
                     jnp.float32)
    cam = jnp.asarray([520.0, 520.0, 320.0, 240.0], jnp.float32)
    p = lie.se3_apply(lie.se3_identity(), xw)
    uv = jnp.stack([cam[0] * p[:, 0] / p[:, 2] + cam[2],
                    cam[1] * p[:, 1] / p[:, 2] + cam[3]], axis=1)
    return xw, uv, jnp.ones(m, bool), cam, p[:, 2]


@pytest.mark.parametrize("rgbd", [False, True])
def test_pose_only_gn_contractions_are_highest(rgbd):
    """The four contractions over the M observations (projection, Jacobian
    chain rule, normal matrix, gradient) run at HIGHEST."""
    m = 37
    xw, uv, valid, cam, depth = _pose_problem(m)

    def fn(T):
        return pose_only_gn(T, xw, uv, valid, cam, iters=3,
                            depth=depth if rgbd else None,
                            bf=jnp.float32(40.0) if rgbd else None)

    rows = 3 if rgbd else 2
    n_hits, unpinned = _unpinned(fn, lie.se3_identity(), size=m)
    n_rows, unpinned_rows = _unpinned(fn, lie.se3_identity(), size=m * rows)
    assert n_hits == 3 and n_rows == 1  # xw@R.T, J, g; H over M*rows
    assert unpinned == [] and unpinned_rows == []
