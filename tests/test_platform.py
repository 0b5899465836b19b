"""Device plumbing that runs on the CPU: the config dict, the compile-cache
helper, the mesh, the device label, the trace reader, and chip_smoke.py's
refusal to run without a GPU."""

import copy
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.parallel.mesh import make_mesh
from equivariant_nn_zoo.utils import build
from equivariant_nn_zoo.utils.compile_cache import ENV_VAR, setup_compile_cache
from equivariant_nn_zoo.utils.config_dict import ConfigDict
from equivariant_nn_zoo.utils.device_info import format_label, parse_nvidia_smi
from equivariant_nn_zoo.utils.profiling import (
    DeviceEvent,
    busy_ns,
    device_events,
    summarize,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------- config dict


def test_config_dict_attribute_access_and_nesting():
    c = ConfigDict()
    c.a = 1
    c.model = {"n_dim": 8, "inner": {"x": 2}}
    assert c["a"] == 1 and c.a == 1
    assert isinstance(c.model, ConfigDict) and c.model.inner.x == 2
    assert isinstance(c, dict) and "model" in c
    c.layers = [("l0", {"module": "m"})]  # dicts in lists stay plain
    assert type(c.layers[0][1]) is dict
    with pytest.raises(AttributeError):
        c.missing
    assert c.get("missing", 3) == 3


def test_config_dict_to_dict_is_plain():
    c = ConfigDict({"a": {"b": {"c": 1}}, "d": [1, 2]})
    d = c.to_dict()
    assert type(d) is dict and type(d["a"]) is dict
    assert type(d["a"]["b"]) is dict and d == {"a": {"b": {"c": 1}},
                                               "d": [1, 2]}


def test_config_dict_flattened_update():
    c = ConfigDict({"model": {"n_dim": 64}})
    c.update_from_flattened_dict({"model.n_dim": 8, "model.l_max": 1,
                                  "batch_size": 4})
    assert c.model.n_dim == 8 and c.model.l_max == 1 and c.batch_size == 4
    with pytest.raises(KeyError):
        c.update_from_flattened_dict({"nothere.x": 1})


def test_config_dict_copy_and_pickle_roundtrip():
    c = ConfigDict({"a": {"b": 1}, "l": [1]})
    for other in (copy.deepcopy(c), pickle.loads(pickle.dumps(c))):
        assert isinstance(other, ConfigDict)
        assert isinstance(other.a, ConfigDict) and other == c
        assert other.a is not c.a


def test_configs_build_from_config_dict():
    cfg = get_config(
        "config_energy",
        "{'model_config.n_dim': 4, 'model_config.l_max': 1, "
        "'model_config.num_layers': 1}",
    )
    assert isinstance(cfg, ConfigDict) and isinstance(cfg.model_config,
                                                      ConfigDict)
    assert cfg.model_config.node_features == "4x0e+4x0o+4x1e+4x1o"
    model = build(cfg.model_config)
    assert model.init(jax.random.PRNGKey(0))


# ------------------------------------------------------------- compile cache


def test_compile_cache_env_var_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(ENV_VAR, "/some/where")
    assert setup_compile_cache(repo_root="/unused") == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = setup_compile_cache(repo_root="/repo/root")
        assert path == os.path.join("/repo/root", ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same on every call: no process id, no time in the name
        assert setup_compile_cache(repo_root="/repo/root") == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ----------------------------------------------------------------------- mesh


def test_make_mesh_raises_when_devices_are_too_few():
    n = len(jax.devices())
    with pytest.raises(ValueError, match="only"):
        make_mesh(n + 1)
    assert make_mesh(n).devices.size == n


# --------------------------------------------------------------- device label


def test_parse_nvidia_smi_and_label():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 700.00 W\n\n")
    cards = parse_nvidia_smi(text)
    assert cards == [("NVIDIA H100 80GB HBM3", "700.00 W")] * 2
    assert format_label(cards) == "2x NVIDIA H100 80GB HBM3, 700.00 W"
    assert format_label(cards[:1] + [("NVIDIA H100 80GB HBM3", "500.00 W")]) \
        == "NVIDIA H100 80GB HBM3, 700.00 W; NVIDIA H100 80GB HBM3, 500.00 W"
    for bad in ("", "no comma here\n"):
        with pytest.raises(ValueError):
            parse_nvidia_smi(bad)


# --------------------------------------------------------------- trace reader


def test_trace_without_device_events_is_an_error(tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    with pytest.raises(RuntimeError, match="no GPU device events"):
        device_events(str(tmp_path))


def test_busy_time_and_idle_share_of_events():
    gpu = "/device:GPU:0"
    events = [DeviceEvent(gpu, "a", 0, 10), DeviceEvent(gpu, "b", 5, 10),
              DeviceEvent(gpu, "a", 30, 10)]
    assert busy_ns(events) == 25
    s = summarize(events, n_steps=1)
    assert s["device_ms_per_step"] == pytest.approx(25e-6)
    assert s["kernel_ms_per_step"] == pytest.approx(30e-6)
    assert s["idle_share"] == pytest.approx(1 - 25 / 40)
    assert s["top_kernels_ms_per_step"][0] == ("a", pytest.approx(20e-6))
    # one device at a time: the first GPU unless another is named
    other = [DeviceEvent("/device:GPU:1", "c", 0, 1)]
    assert summarize(events + other, 1) == s
    assert summarize(events + other, 1, device="/device:GPU:1")[
        "kernel_ms_per_step"] == pytest.approx(1e-6)


# ---------------------------------------------------------------- chip smoke


def test_chip_smoke_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_four_card_option_runs_only_its_phase(capsys):
    assert chip_smoke.phases_for(4) == ("device", "data_parallel")
    assert "data_parallel" not in chip_smoke.phases_for(1)
    assert chip_smoke.parse_args(["--chips", "4"]).chips == 4
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--chips", "2"])
    assert chip_smoke.main(["--chips", "4"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_without_the_repo_fails():
    with tempfile.TemporaryDirectory() as d:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), d)
        env = dict(os.environ, PYTHONPATH="")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d,
                              env=env, capture_output=True, text=True,
                              timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
