"""VP-SDE diffusion stack tests: marginal statistics, score loss, step fn
with NaN-skip/grad-acc/EMA, PC sampler, device-side radius graph."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from equivariant_nn_zoo.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
    radius_graph_fixed,
)
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.run.sde_sampling import (
    get_corrector,
    get_pc_sampler,
    get_predictor,
)
from equivariant_nn_zoo.run.sde_utils import (
    VPSDE,
    get_sde_loss_fn,
    get_step_fn,
    init_sde_state,
)
from equivariant_nn_zoo.utils import build


RNG = np.random.default_rng(3)


def diffusion_batch(n_graphs=4):
    mols = []
    for _ in range(n_graphs):
        n = int(RNG.integers(4, 8))
        d = {
            "pos": RNG.normal(size=(n, 3)),
            "species": RNG.integers(1, 9, size=(n, 1)),
            "total_energy": RNG.normal(size=(1, 1)),
        }
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "total_energy": ("graph", "1x0e"),
        }
        out, attrs = computeEdgeIndex(d, attrs, r_max=9999)
        d.update(out)
        d["bond_type"] = RNG.integers(0, 4, size=(d["edge_index"].shape[1], 1))
        attrs["bond_type"] = ("edge", "1x0e")
        mols.append(Data(attrs, **d))
    return GraphBatch.from_batch(Batch.from_data_list(mols), 48, 256, n_graphs)


@pytest.fixture(scope="module")
def diffusion_model():
    cfg = get_config("config_diffusion")
    cfg.model_config.num_layers = 1
    cfg.model_config.n_dim = 8
    # rebuild layer list with the smaller model
    cfg = get_config("config_diffusion")
    model = build(cfg.model_config)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


def test_vpsde_marginal_statistics():
    sde = VPSDE({"pos": 3}, beta_min=0.1, beta_max=20, N=100)
    gb = diffusion_batch()
    gb = gb.replace(t=jnp.full((4, 1), 0.99))
    gb.attrs["t"] = ("graph", "1x0e")
    perturbed, misc = sde.marginal(gb, jax.random.PRNGKey(0))
    # at t ~ 1 the marginal is ~N(0,1): std near 1
    assert float(misc["std"].max()) > 0.99
    mask = np.asarray(gb["_node_mask"])[:, 0] > 0
    x = np.asarray(perturbed["pos"])[mask]
    assert 0.5 < x.std() < 2.0
    # near t=0 the data is nearly unperturbed
    gb0 = gb.replace(t=jnp.full((4, 1), 1e-4))
    perturbed0, misc0 = sde.marginal(gb0, jax.random.PRNGKey(1))
    np.testing.assert_allclose(
        np.asarray(perturbed0["pos"])[mask], np.asarray(gb["pos"])[mask],
        atol=0.05,
    )


def test_vpsde_tables_finite_for_coarse_schedules():
    # Coarse discrete schedules (beta_max/N >= 1, e.g. num_scales=10 smoke
    # configs) used to drive alphas_cumprod negative -> NaN sqrt tables,
    # silently skipped steps via the NaN guard. All tables must stay finite
    # and within their mathematical ranges for any N.
    for n in (2, 10, 50, 1000):
        sde = VPSDE({"pos": 3}, beta_min=0.1, beta_max=20, N=n)
        for name in ("alphas_cumprod", "sqrt_alphas_cumprod",
                     "sqrt_1m_alphas_cumprod", "discrete_betas"):
            table = getattr(sde, name)
            assert np.isfinite(table).all(), (name, n)
        assert (sde.alphas_cumprod >= 0).all() and (
            sde.alphas_cumprod <= 1).all()
        assert (sde.sqrt_1m_alphas_cumprod <= 1).all()


def test_sde_loss_and_train_step(diffusion_model):
    cfg, model, params = diffusion_model
    sde = VPSDE(dict(cfg.diffusion_keys), N=50)
    gb = diffusion_batch()
    optimizer = optax.adam(1e-3)
    state = init_sde_state(params, optimizer, jax.random.PRNGKey(1))
    step = get_step_fn(sde, True, model=model, optimizer=optimizer,
                       grad_clid_norm=1.0, grad_acc=2, ema_decay=0.99)
    losses = []
    for _ in range(4):
        state, loss, parts = step(state, gb)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert int(state["step"]) == 4
    assert "total" in parts
    # eval under EMA params
    eval_step = get_step_fn(sde, False, model=model)
    state, eloss, _ = eval_step(state, gb)
    assert np.isfinite(float(eloss))


def test_nan_grad_skip(diffusion_model):
    """A batch engineered to produce NaN gradients must not corrupt params."""
    cfg, model, params = diffusion_model
    sde = VPSDE(dict(cfg.diffusion_keys), N=50)
    gb = diffusion_batch()
    bad = gb.replace(pos=gb["pos"] * jnp.nan)
    optimizer = optax.adam(1e-3)
    state = init_sde_state(params, optimizer, jax.random.PRNGKey(1))
    step = get_step_fn(sde, True, model=model, optimizer=optimizer,
                       grad_acc=1)
    before = jax.device_get(state["params"])
    state, loss, _ = step(state, bad)
    after = jax.device_get(state["params"])
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)
        assert np.all(np.isfinite(b))


def test_pc_sampler(diffusion_model):
    cfg, model, params = diffusion_model
    sde = VPSDE(dict(cfg.diffusion_keys), N=50)
    gb = diffusion_batch()
    pc = get_pc_sampler(
        sde, get_predictor("euler_maruyama"), get_corrector("langevin"),
        None, snr=0.16, n_steps=1, eps=1e-3,
    )
    out, nfe = jax.jit(lambda p, b, k: pc(model, p, b, k))(
        params, gb, jax.random.PRNGKey(2)
    )
    assert nfe == 100
    assert bool(jnp.all(jnp.isfinite(out["pos"])))
    # positions actually moved from the prior
    host = out.to_batch()
    assert len(host) == 4


def test_registries():
    assert get_predictor("none") is not None
    assert get_corrector("none") is not None
    with pytest.raises(KeyError):
        get_predictor("nonexistent")


def test_radius_graph_fixed_matches_host():
    n = 16
    pos = jnp.asarray(RNG.normal(size=(n, 3)) * 1.5, jnp.float32)
    seg = jnp.zeros((n,), jnp.int32).at[n - 1].set(1)  # last is dummy
    mask = jnp.ones((n, 1), jnp.float32).at[n - 1].set(0.0)
    ei, emask, eseg, n_cand = radius_graph_fixed(pos, seg, mask, 256, 2.5, n - 1)
    kept = int(emask.sum())
    # host-side count of the same edges
    p = np.asarray(pos)[: n - 1]
    d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
    expect = int(((d < 2.5) & ~np.eye(n - 1, dtype=bool)).sum())
    assert kept == expect
    # padded entries all point at the dummy node
    ei_np = np.asarray(ei)
    assert np.all(ei_np[:, kept:] == n - 1)


def test_ode_sampler(diffusion_model):
    from equivariant_nn_zoo.run.sde_sampling import get_ode_sampler

    cfg, model, params = diffusion_model
    sde = VPSDE(dict(cfg.diffusion_keys), N=50)
    gb = diffusion_batch()
    ode = get_ode_sampler(sde, None, eps=1e-3, n_steps=8)
    out, nfe = jax.jit(lambda p, b, k: ode(model, p, b, k))(
        params, gb, jax.random.PRNGKey(4)
    )
    assert nfe == 14
    assert bool(jnp.all(jnp.isfinite(out["pos"])))
    # deterministic given the prior draw: same key -> same samples
    out2, _ = jax.jit(lambda p, b, k: ode(model, p, b, k))(
        params, gb, jax.random.PRNGKey(4)
    )
    np.testing.assert_allclose(np.asarray(out["pos"]),
                               np.asarray(out2["pos"]), atol=1e-5)


def test_sde_checkpoint_resume(diffusion_model, tmp_path):
    """Diffusion state save/restore: params, EMA, step, rng survive."""
    from equivariant_nn_zoo.utils.saveload import (
        finish_all_writes,
        restore_checkpoint,
        save_checkpoint,
    )

    cfg, model, params = diffusion_model
    sde = VPSDE(dict(cfg.diffusion_keys), N=50)
    gb = diffusion_batch()
    optimizer = optax.adam(1e-3)
    state = init_sde_state(params, optimizer, jax.random.PRNGKey(1))
    step = get_step_fn(sde, True, model=model, optimizer=optimizer)
    for _ in range(3):
        state, loss, _ = step(state, gb)
    path = str(tmp_path / "ckpt.pth")
    save_checkpoint(path, state, blocking=True)
    finish_all_writes()

    restored = restore_checkpoint(path, None)
    assert int(restored["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(state["params"])),
                    jax.tree_util.tree_leaves(restored["params"])):
        np.testing.assert_array_equal(a, b)
    # missing file returns the input state gracefully
    same = restore_checkpoint(str(tmp_path / "nope.pth"), state)
    assert same is state
    # training continues from the restored state
    restored = jax.device_put(restored)
    restored, loss, _ = step(restored, gb)
    assert int(restored["step"]) == 4
    assert np.isfinite(float(loss))
