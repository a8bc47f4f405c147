"""The dataclass-pytree helper, the precision pin and the compile cache.

* `utils.struct`: `.replace`, static fields, flatten/unflatten, jit.
* `utils.precision`: every float32 matrix product the solver entry points
  trace carries `precision = HIGHEST`, with no global flag set (on a GPU
  the default would be TF32).
* `utils.compile_cache`: defers to JAX_COMPILATION_CACHE_DIR, else a
  fixed directory inside the checkout.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.utils import compile_cache, struct


class _Node(struct.PyTreeNode):
    a: jnp.ndarray
    b: jnp.ndarray
    mode: str = struct.field(pytree_node=False, default="x")


def test_struct_replace_returns_modified_copy():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3))
    m = n.replace(a=jnp.full(2, 5.0))
    assert float(m.a[0]) == 5.0 and float(n.a[0]) == 1.0
    assert m.mode == "x"
    with pytest.raises(dataclasses.FrozenInstanceError):
        n.a = jnp.zeros(2)


def test_struct_static_fields_are_treedef_metadata():
    n1 = _Node(a=jnp.ones(2), b=jnp.zeros(3), mode="x")
    n2 = _Node(a=jnp.ones(2), b=jnp.zeros(3), mode="y")
    assert len(jax.tree.leaves(n1)) == 2
    assert jax.tree.structure(n1) != jax.tree.structure(n2)


def test_struct_flatten_unflatten_round_trip():
    n = _Node(a=jnp.arange(2.0), b=jnp.arange(3.0), mode="z")
    leaves, treedef = jax.tree.flatten(n)
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, _Node) and back.mode == "z"
    np.testing.assert_array_equal(back.b, n.b)
    doubled = jax.tree.map(lambda x: 2 * x, n)
    np.testing.assert_array_equal(doubled.a, 2 * n.a)


def test_struct_through_jit_and_vmap():
    n = _Node(a=jnp.ones((4, 2)), b=jnp.ones((4, 3)), mode="w")

    @jax.jit
    def f(node):
        assert node.mode == "w"     # static: a Python value under trace
        return node.replace(a=node.a + node.b.sum())

    out = jax.vmap(f)(n)
    assert out.mode == "w"
    np.testing.assert_allclose(out.a, 4.0)


def _tiny_f32_problem():
    from centroidal_mpc_tpu.config import gaits, presets
    gait = dataclasses.replace(gaits.SOLO12_TROT, step_length=0.0,
                               step_knots=3, support_knots=1, nb_steps=1)
    preset = dataclasses.replace(presets.SOLO12_TROT, name="tiny",
                                 gait=gait)
    return presets.build_problem(preset, dtype=jnp.float32)


def _entry(name):
    """(function, args) for one solver entry point at f32."""
    from centroidal_mpc_tpu.models.centroidal import compute_trajectory_data
    from centroidal_mpc_tpu.ops import blockqp
    from centroidal_mpc_tpu.ops.admm import QPSettings
    from centroidal_mpc_tpu.ops.linalg import spd_inverse
    from centroidal_mpc_tpu.solver.scp import solve_scp
    p = _tiny_f32_problem()
    sched = p.plan.schedule
    if name == "solve_block_qp":
        def fn(X, U):
            data = compute_trajectory_data(p.model, sched, X, U,
                                           with_covariance=False)
            qp = blockqp.build_block_qp(p.model, sched, p.ocp, X, U, data,
                                        jnp.float32(100.0),
                                        jnp.float32(100.0))
            return blockqp.solve_block_qp(
                qp, QPSettings(max_iter=50, polish=True)).X
        return fn, (p.X0, p.U0)
    if name == "solve_scp":
        scp = dataclasses.replace(
            p.scp, qp_backend="block",
            qp=QPSettings(max_iter=50, polish=True))
        return (lambda X, U: solve_scp(p.model, sched, p.ocp, X, U,
                                       scp).X), (p.X0, p.U0)
    if name == "compute_trajectory_data":
        return (lambda X, U: compute_trajectory_data(
            p.model, sched, X, U).Sigma), (p.X0, p.U0)
    H = jnp.eye(6, dtype=jnp.float32) * 2.0
    return spd_inverse, (H,)


@pytest.mark.parametrize("name", ["solve_block_qp", "solve_scp",
                                  "compute_trajectory_data", "spd_inverse"])
def test_every_f32_dot_general_is_highest(name):
    """The f32 HLO of each entry point has every dot_general at HIGHEST
    although the process-wide default precision is unset."""
    assert jax.config.jax_default_matmul_precision is None
    fn, args = _entry(name)
    text = jax.jit(fn).lower(*args).as_text()
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", text)
    assert dots, "no matrix products traced"
    f32_dots = [d for d in dots if "f32>" in d]
    assert f32_dots
    bad = [d for d in f32_dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not bad, bad[:3]


def test_compile_cache_defers_to_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
