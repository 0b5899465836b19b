"""Inference CLI — batch-evaluate a trained model and dump outputs to HDF5.

Reference parity: the reference inference.py (C28 in SURVEY.md §2).
"""

import logging
import os

import numpy as np
from absl import app, flags

flags.DEFINE_string("config", None, "The name of the config.")
flags.DEFINE_string("config_spec", "", "Config specification.")
flags.DEFINE_string("model_path", None, "Path of the model checkpoint.")
flags.DEFINE_string("output_path", "inference.hdf5", "Output HDF5 path.")
flags.DEFINE_string("output_keys", "", "Comma-separated output keys to dump.")
flags.DEFINE_integer("seed", 0, "The RNG seed.")
flags.DEFINE_integer("batch_size", 0, "Override config batch size.")
flags.DEFINE_boolean("equivariance_test", False,
                     "Fill the dataset with rotated copies first.")
flags.DEFINE_string("verbose", "INFO", "Logging verbosity.")

FLAGS = flags.FLAGS


def evaluate(argv):
    import jax

    from equivariant_nn_zoo.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from equivariant_nn_zoo import models as configs
    from equivariant_nn_zoo.data.batch import Batch
    from equivariant_nn_zoo.data.dataloader import DataLoader
    from equivariant_nn_zoo.data.dataset import CondensedDataset
    from equivariant_nn_zoo.utils import build, pruneArgs
    from equivariant_nn_zoo.utils.saveload import load_file

    logging.basicConfig(level=getattr(logging, FLAGS.verbose.upper(),
                                      logging.INFO))
    config = configs.get_config(FLAGS.config, FLAGS.config_spec or None)
    model = build(config.model_config)
    if FLAGS.model_path:
        params = load_file(FLAGS.model_path, enforced_format="pickle")
        if isinstance(params, dict) and "model_params" in params:
            params = params["model_params"]  # a trainer.pt
        if isinstance(params, dict) and "params" in params and "step" in params:
            params = params["params"]  # a diffusion state
        params = jax.device_put(params)
    else:
        params = model.init(jax.random.PRNGKey(FLAGS.seed))

    data_config = dict(config.data_config)
    dataset = CondensedDataset(**pruneArgs(CondensedDataset, **data_config))
    if FLAGS.equivariance_test:
        dataset.equivarianceTest(config.batch_size)
    batch_size = FLAGS.batch_size or config.batch_size
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False)

    output_keys = [k for k in FLAGS.output_keys.split(",") if k]
    fwd = jax.jit(lambda p, b: model.apply(p, b))
    results = []
    for gb in loader:
        out = fwd(params, gb)
        host = out.to_batch()
        if not output_keys:
            output_keys = [
                k for k in host.keys()
                if k in host.attrs and not k.startswith("_")
            ]
        n_real = int(np.asarray(gb["_graph_mask"]).sum())
        keep = {k: host[k] for k in output_keys if k in host.keys()}
        keep["_n_nodes"] = host["_n_nodes"]
        attrs = {k: host.attrs[k] for k in keep if k in host.attrs}
        sub = Batch(attrs, **keep).index_select(list(range(n_real)))
        results.append(sub)
    merged = Batch.from_data_list(results)
    merged.dumpHDF5(FLAGS.output_path)
    logging.info(f"Wrote {len(merged)} graphs to {FLAGS.output_path}")
    return merged


if __name__ == "__main__":
    flags.mark_flags_as_required(["config"])
    app.run(evaluate)
