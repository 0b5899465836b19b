"""Metrics: mae/rmse per key with PerSpecies/PerAtom variants, running
accumulation, and flattening for logs/wandb.

Reference parity: e3_layers/run/metrics.py (C18 in SURVEY.md §2).  The
torch_runstats RunningStats is replaced by a mask-aware device-side
sum/count accumulation: per-batch partial sums stay on device (async) and
are only pulled to host at result time.
"""

from __future__ import annotations

import json
from copy import deepcopy
from hashlib import sha1
from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .loss import find_loss_function

metrics_to_reduction = {"mae": "mean", "mean": "mean", "rmse": "rms"}


class RunningStats:
    """Masked running mean / rms over batches, optionally binned by species."""

    def __init__(self, reduction: str = "mean", dim=(), accumulate_bins=None):
        assert reduction in ("mean", "rms")
        self.reduction = reduction
        self.bins = accumulate_bins
        self.reset()

    def reset(self):
        self._sums = []
        self._counts = []

    def batch_partials(self, values, weights, accumulate_by=None):
        """Pure per-batch partial sums (jit-safe — no state mutation).
        Returns (sum, count, display_value)."""
        if self.reduction == "rms":
            values = values * values
        if accumulate_by is None:
            s = jnp.sum(values * weights)
            c = jnp.sum(weights * jnp.ones_like(values))
            disp = s / jnp.maximum(c, 1.0)
        else:
            nbins = self.bins
            s = jax.ops.segment_sum(
                jnp.sum(values * weights, axis=tuple(range(1, values.ndim))),
                accumulate_by, num_segments=nbins,
            )
            c = jax.ops.segment_sum(
                jnp.sum(weights * jnp.ones_like(values),
                        axis=tuple(range(1, values.ndim))),
                accumulate_by, num_segments=nbins,
            )
            disp = s
        return s, c, disp

    def ingest(self, partials):
        """Store one batch's (sum, count, display) partials."""
        s, c, disp = partials
        self._sums.append(s)
        self._counts.append(c)
        return disp

    def accumulate_batch(self, values, weights, accumulate_by=None):
        """values/weights: [N, ...]; accumulate_by: [N] int bins or None."""
        return self.ingest(self.batch_partials(values, weights,
                                               accumulate_by))

    def current_result(self):
        if not self._sums:
            return np.float32(0.0)
        # reduce on device, transfer once
        s = np.asarray(jnp.sum(jnp.stack(self._sums), axis=0), np.float64)
        c = np.asarray(jnp.sum(jnp.stack(self._counts), axis=0), np.float64)
        out = s / np.maximum(c, 1.0)
        if self.reduction == "rms":
            out = np.sqrt(out)
        return out.astype(np.float32)

    @property
    def output_dim(self):
        return tuple()


class Metrics:
    """Reference parity: metrics.py:20-209 (API preserved: components list,
    __call__(pred, ref) accumulates, current_result, flatten_metrics)."""

    NUM_TYPES = 200

    def __init__(self, components: Sequence[Union[Tuple[str, str], Tuple[str, str, dict]]]):
        self.running_stats = {}
        self.params = {}
        self.funcs = {}
        self.kwargs = {}
        if hasattr(components, "items"):  # dict {key: [reductions]}
            flat = []
            for key, reductions in components.items():
                for r in reductions:
                    flat.append((key, r) if isinstance(r, str) else (key, *r))
            components = flat
        for component in components:
            key, reduction, params = Metrics.parse(component)
            params["PerSpecies"] = params.get("PerSpecies", False)
            params["PerAtom"] = params.get("PerAtom", False)
            param_hash = Metrics.hash_component(component)
            functional = params.get("functional", "L1Loss")
            if key not in self.running_stats:
                self.running_stats[key] = {}
                self.funcs[key] = find_loss_function(functional, {})
                self.kwargs[key] = {}
                self.params[key] = {}
            self.kwargs[key][param_hash] = dict(
                reduction=metrics_to_reduction.get(reduction, reduction)
            )
            self.params[key][param_hash] = (reduction, params)
            self.running_stats[key][param_hash] = RunningStats(
                reduction=metrics_to_reduction.get(reduction, reduction),
                accumulate_bins=self.NUM_TYPES if params["PerSpecies"] else None,
            )

    @staticmethod
    def hash_component(component):
        buffer = json.dumps(_plain(component), sort_keys=True).encode("ascii")
        return sha1(buffer).hexdigest()

    @staticmethod
    def parse(component):
        reduction, params = "mae", {}
        if isinstance(component, str):
            key = component
        elif len(component) == 1:
            key = component[0]
        elif len(component) == 2:
            key, reduction = component
        elif len(component) == 3:
            key, reduction, _params = component
            params = {k: deepcopy(v) for k, v in _params.items()}
        else:
            raise ValueError(
                f"tuple should have a max length of 3 but {len(component)} is given"
            )
        return key, reduction, params

    def batch_stats(self, pred: dict, ref: dict):
        """Pure per-batch partial sums for every registered metric — safe
        to call under jit so the whole accumulation costs ONE dispatch per
        batch."""
        stats = {}
        for key, func in self.funcs.items():
            if hasattr(func, "raw"):
                error, weights = func.raw(pred, ref, key)
            else:
                error = func(pred=pred, ref=ref, key=key, mean=False)
                weights = jnp.ones_like(error)
            for param_hash, kwargs in self.kwargs[key].items():
                _, params = self.params[key][param_hash]
                stat = self.running_stats[key][param_hash]
                accumulate_by = None
                if params["PerSpecies"]:
                    accumulate_by = pred["atom_types"].reshape(-1).astype(
                        jnp.int32
                    )
                error_n = error
                if params["PerAtom"]:
                    N = ref["_n_nodes"].reshape(
                        error.shape[:-1] + (1,)
                    ).astype(error.dtype)
                    error_n = error / jnp.maximum(N, 1.0)
                stats[(key, param_hash)] = stat.batch_partials(
                    error_n, weights, accumulate_by=accumulate_by
                )
        return stats

    def ingest(self, stats):
        """Store jitted batch_stats output into the running accumulators."""
        return {
            kh: self.running_stats[kh[0]][kh[1]].ingest(partials)
            for kh, partials in stats.items()
        }

    def __call__(self, pred: dict, ref: dict):
        return self.ingest(self.batch_stats(pred, ref))

    def reset(self):
        for stats in self.running_stats.values():
            for stat in stats.values():
                stat.reset()

    def current_result(self):
        return {
            (key, h): stat.current_result()
            for key, stats in self.running_stats.items()
            for h, stat in stats.items()
        }

    def flatten_metrics(self, metrics, type_names=None):
        """Reference parity: metrics.py:211-256."""
        flat_dict = {}
        skip_keys = []
        for k, value in metrics.items():
            key, param_hash = k
            reduction, params = self.params[key][param_hash]
            short_name = key
            per_atom = params["PerAtom"]
            suffix = "/N" if per_atom else ""
            item_name = f"{short_name}{suffix}_{reduction}"
            per_species = params["PerSpecies"]
            value = np.asarray(value)
            if per_species:
                names = type_names or [str(i) for i in range(len(value))]
                present = value != 0
                for id_ele, v in enumerate(np.asarray(value).flatten()):
                    if id_ele < len(names) and present.flatten()[id_ele]:
                        flat_dict[f"{names[id_ele]}_{item_name}"] = float(v)
                nz = value[present] if present.any() else value
                flat_dict[f"psavg_{item_name}"] = float(np.mean(nz))
            else:
                if value.ndim == 0:
                    flat_dict[item_name] = float(value)
                else:
                    for idx, v in enumerate(value.flatten()):
                        flat_dict[f"{item_name}_{idx}"] = float(v)
        return flat_dict, skip_keys


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    return x if isinstance(x, (str, int, float, bool, type(None))) else str(x)
