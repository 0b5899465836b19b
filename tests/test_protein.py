"""Protein diffusion pipeline: masked2indexed -> crop -> device radius graph
(with chain criteria) -> CA diffusion training step -> PC sampling -> pdb."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from equivariant_nn_zoo.data import Batch
from equivariant_nn_zoo.data.dataloader import getDataIters
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.models.protein_utils import crop, masked2indexed
from equivariant_nn_zoo.run import sde_utils
from equivariant_nn_zoo.run.sde_sampling import (
    get_corrector,
    get_pc_sampler,
    get_predictor,
)
from equivariant_nn_zoo.utils import build
from equivariant_nn_zoo.utils.saveload import saveProtein


RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def protein_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("prot") / "pdb_0.hdf5"
    items = []
    for _ in range(16):
        n = int(RNG.integers(24, 48))
        t = np.cumsum(RNG.normal(size=(n, 3)) * 2.0, axis=0)
        item = {
            "species": RNG.integers(0, 20, size=(n, 1)),
            "chain_id": (np.arange(n) // 24).reshape(-1, 1),
            "mask": (RNG.random((n, 1)) < 0.9).astype(np.int64),
            "_n_nodes": n,
            "CA": t.astype(np.float32),
        }
        for a in ["C", "N", "O"]:
            item[a] = (t + RNG.normal(size=(n, 3)) * 0.5).astype(np.float32)
        items.append(item)
    attrs = {
        "species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
        "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e"),
    }
    for a in ["CA", "C", "N", "O"]:
        attrs[a] = ("node", "1x1o")
    Batch.from_data_list(items, attrs).dumpHDF5(str(path))
    return str(path)


def test_masked2indexed_and_crop(protein_file):
    from equivariant_nn_zoo.data.dataset import CondensedDataset

    ds = CondensedDataset(path=protein_file)
    raw = ds.get(0)
    out = masked2indexed(raw)
    n_kept = int(np.asarray(out["_n_nodes"]).reshape(-1)[0])
    assert n_kept == int(np.asarray(raw["mask"]).sum())
    assert "id" in out.keys()
    # crop to a small max_nodes
    data, attrs = crop(dict(out.data), dict(out.attrs), max_nodes=10,
                       rng=np.random.default_rng(0))
    assert int(np.asarray(data["_n_nodes"]).reshape(-1)[0]) <= n_kept
    assert "N" not in data  # dropped by the CA-only crop


def test_ca_diffusion_pipeline(protein_file, tmp_path):
    cfg = get_config("config_diffusion_CA")
    cfg.batch_size = 2
    cfg.data_config.path = [protein_file]
    cfg.data_config.n_train = 0.7
    cfg.data_config.n_val = 0.3
    cfg.data_config.edge_capacity = 4096
    model = build(cfg.model_config)
    train_iter, _ = getDataIters(cfg, seed=0)
    gb = next(train_iter)
    assert gb.edge_capacity == 4096  # the config override is honored
    gb = cfg.data_config.scaler(gb)

    sde = sde_utils.VPSDE(dict(cfg.diffusion_keys), N=20)
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    state = sde_utils.init_sde_state(params, opt, jax.random.PRNGKey(1))
    step = sde_utils.get_step_fn(
        sde, True, model=model, optimizer=opt,
        grad_clid_norm=1.0, grad_acc=cfg.grad_acc,
    )
    state, loss, parts = step(state, gb)
    assert np.isfinite(float(loss))

    # the device edge layer reports zero overflow at this capacity
    gb_t = gb.replace(t=jnp.full((gb.n_graphs, 1), 0.5))
    gb_t.attrs["t"] = ("graph", "1x0e")
    out = model.apply(state["params"], gb_t)
    assert int(np.asarray(out["_edge_overflow"]).max()) == 0
    # and real edges exist
    assert int(np.asarray(out["_n_edges"]).sum()) > 0

    pc = get_pc_sampler(
        sde, get_predictor("euler_maruyama"), get_corrector("langevin"),
        None, snr=0.16, n_steps=1, eps=1e-3,
    )
    sampled, nfe = pc(model, state["ema"]["params"], gb,
                      jax.random.PRNGKey(2))
    assert bool(jnp.all(jnp.isfinite(sampled["CA"])))
    host = cfg.data_config.inverse_scaler(sampled.to_batch())
    f = saveProtein(host, str(tmp_path), filename="sample")
    content = open(f).read()
    assert "CA" in content and content.strip().endswith("END")
