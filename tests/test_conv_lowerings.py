"""The conv's two lowerings — the fused XLA conv (``FusedUVUConv`` with
``FusedScalarFCTP``) and the unfused per-path reference — at the irreps of
every workload config, the force path through a conv against finite
differences, and the self-connection against its reference.  The same
comparisons run at real widths on a GPU in ``chip_smoke.py`` phase 3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.ops.fused_tp import FusedScalarFCTP
from equivariant_nn_zoo.ops.irreps import Irreps
from equivariant_nn_zoo.ops.tensor_product import fully_connected_tp
from equivariant_nn_zoo.utils import build

# float32 against float32 on a few small molecules: only the summation
# order differs (chip_smoke.TOLERANCES hold at real widths on the card)
TOL = 1e-5

CONFIGS = {
    "config_energy": bench.synthetic_qm9,
    "config_energy_force": bench.synthetic_fragments,
    "config_dipole": bench.synthetic_dipole_mols,
    "config_hamiltonian": bench.synthetic_h2o,
    "config_diffusion": bench.synthetic_diffusion_mols,
}


@functools.lru_cache(maxsize=None)
def _trunk_conv(config_name):
    cfg = get_config(config_name)
    return cs.find_conv(build(cfg.model_config)), float(cfg.model_config.r_max)


@functools.lru_cache(maxsize=None)
def _graph(config_name, n_mol=2):
    _, r_max = _trunk_conv(config_name)
    return cs.parity_graph(CONFIGS[config_name], n_mol, 0, r_max)


@functools.lru_cache(maxsize=None)
def _conv_parity(config_name):
    conv, r_max = _trunk_conv(config_name)
    pos, edge_index = _graph(config_name)
    return cs.conv_parity(conv, pos, edge_index, r_max, seed=0,
                          modes=("f32_highest",))["f32_highest"]


@pytest.mark.parametrize("quantity", ["forward", "grad_params"])
@pytest.mark.parametrize("config_name", sorted(CONFIGS))
def test_fused_conv_matches_unfused_reference(config_name, quantity):
    err = _conv_parity(config_name)[quantity]
    assert err <= TOL, (config_name, quantity, err)


def test_fused_conv_feature_gradient_matches_reference():
    err = _conv_parity("config_energy")["grad_features"]
    assert err <= TOL, err


def test_force_path_fused_matches_unfused_reference():
    conv, r_max = _trunk_conv("config_energy_force")
    pos, edge_index = _graph("config_energy_force")
    errs = cs.force_parity(conv, pos, edge_index, r_max, seed=0,
                           modes=("f32_highest",))["f32_highest"]
    for name, err in errs.items():
        assert err <= TOL, (name, err)


def _force_fns(config_name, seed=0):
    """energy(params, pos) and force_loss(params, pos) through the fused
    float32 conv, the functions chip_smoke.force_parity compares."""
    conv, r_max = _trunk_conv(config_name)
    conv = cs.conv_variant(conv, True, "float32")
    pos, edge_index = _graph(config_name)
    rng = np.random.default_rng(seed)
    x, attrs = cs.node_inputs(conv, pos.shape[0], rng)
    first = Irreps(conv.irreps_out["output_features"])[0]
    w = jnp.asarray(rng.normal(size=(first.mul,)), jnp.float32)
    c = jnp.asarray(rng.normal(size=pos.shape), jnp.float32)

    def energy(p, r):
        sh, radial = cs.edge_geometry(conv, r, edge_index, r_max)
        out = cs._apply(conv, p, x, attrs, sh, radial, edge_index)
        return jnp.sum(out[:, :first.mul] * w)

    def force_loss(p, r):
        return jnp.sum(-jax.grad(energy, argnums=1)(p, r) * c)

    params = conv.init(jax.random.PRNGKey(seed))
    return energy, force_loss, params, jnp.asarray(pos), rng


def _central_difference(f, h):
    return (f(h) - f(-h)) / (2 * h)


@pytest.mark.parametrize("config_name", ["config_energy", "config_energy_force"])
def test_forces_match_finite_differences(config_name):
    energy, _, params, pos, rng = _force_fns(config_name)
    u = jnp.asarray(rng.normal(size=pos.shape), jnp.float32)
    analytic = float(jnp.sum(jax.grad(energy, argnums=1)(params, pos) * u))
    e = jax.jit(lambda h: energy(params, pos + h * u))
    # h balances truncation (close atom pairs curve the energy sharply)
    # against float32 rounding
    numeric = float(_central_difference(e, 3e-3))
    assert abs(analytic - numeric) <= 1e-2 * abs(analytic), (analytic, numeric)


@pytest.mark.parametrize("config_name", ["config_energy", "config_energy_force"])
def test_force_loss_param_gradient_matches_finite_differences(config_name):
    """The double backward: d/dparams of a loss on forces."""
    _, force_loss, params, pos, rng = _force_fns(config_name)
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), params)
    g = jax.grad(force_loss)(params, pos)
    analytic = float(sum(jnp.sum(a * b) for a, b in zip(
        jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(v))))
    shifted = jax.jit(lambda h: force_loss(
        jax.tree_util.tree_map(lambda p, d: p + h * d, params, v), pos))
    numeric = float(_central_difference(shifted, 3e-3))
    assert abs(analytic - numeric) <= 2e-2 * abs(analytic), (analytic, numeric)


@pytest.mark.parametrize("irreps_in,attrs,irreps_out", [
    ("8x0e+8x1o+8x2e", "4x0e", "8x0e+8x1o+8x2e"),
    ("4x0e+4x0o+4x1e+4x1o", "10x0e", "6x0e+2x1o+3x1e"),
    ("3x0e+2x1o+5x2e+1x3o", "1x0e+2x0e", "2x0e+2x2e+2x3o"),
])
def test_fused_scalar_fctp_matches_reference(irreps_in, attrs, irreps_out):
    tp = fully_connected_tp(Irreps(irreps_in), Irreps(attrs),
                            Irreps(irreps_out))
    fused = FusedScalarFCTP(tp, compute_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    n = 11
    x = jnp.asarray(rng.normal(size=(n, Irreps(irreps_in).dim)), jnp.float32)
    a = jnp.asarray(rng.normal(size=(n, Irreps(attrs).dim)), jnp.float32)
    params = {k: jnp.asarray(rng.normal(size=shape), jnp.float32)
              for k, (shape, _) in tp.param_specs().items()}
    np.testing.assert_allclose(np.asarray(fused.apply(params, x, a)),
                               np.asarray(tp.apply(params, x, a)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_conv_parity_at_config_energy_width_on_gpu(gpu_device):
    """Phase 3 of chip_smoke.py as a test: ~2k nodes, ~28k edges."""
    conv, r_max = _trunk_conv("config_energy")
    pos, edge_index = cs.parity_graph(bench.synthetic_qm9, 128, 0, r_max)
    with jax.default_device(gpu_device):
        result = cs.conv_parity(conv, pos, edge_index, r_max, seed=0)
    for mode, errs in result.items():
        for name, err in errs.items():
            assert err <= cs.TOLERANCES[mode], (mode, name, err)
