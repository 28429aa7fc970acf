"""State carried across from the JAX package, at the numpy level.

These functions turn the kernel inputs of pipelinedp_tpu, once extracted to
numpy arrays and plain Python values, into the port's, so one state can be
fed to both packages: the encoded columns, the KernelConfig fields, the
noise stds, the SelectionParams fields, the uint32[2] threefry key, a
privacy loss distribution's fields and the analysis sweep's
SweepConfigArrays; either package's dataset histograms into plain tuples
for comparison; and the utility-analysis and tuning options of either
package from one set of plain fields. Nothing here imports the JAX
package; the caller does the extracting (e.g. `dataclasses.asdict` of its
KernelConfig) or passes the package's modules.
"""

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch.accounting import pld as pldlib
from pipelinedp_tpu_torch.analysis import kernels as analysis_kernels
from pipelinedp_tpu_torch.aggregate_params import NoiseKind, NormKind
from pipelinedp_tpu_torch.ops import selection_ops

def encoded_data(pid: np.ndarray, pk: np.ndarray, values: np.ndarray,
                 partition_vocab: Sequence[Any], n_privacy_ids: int,
                 public_encoded: bool = False) -> columnar.EncodedData:
    """The JAX package's EncodedData arrays as the port's EncodedData."""
    return columnar.EncodedData(
        pid=np.asarray(pid, dtype=np.int32),
        pk=np.asarray(pk, dtype=np.int32),
        values=np.asarray(values, dtype=np.float64),
        partition_vocab=partition_vocab,
        n_privacy_ids=int(n_privacy_ids),
        public_encoded=bool(public_encoded))


def selection_params(fields: Mapping[str, Any]) -> selection_ops.SelectionParams:
    """SelectionParams from the JAX package's SelectionParams fields."""
    return selection_ops.SelectionParams(**dict(fields))


def kernel_config(fields: Mapping[str, Any]) -> executor.KernelConfig:
    """KernelConfig from the JAX package's KernelConfig fields (plan
    entries and selection as mappings or dataclass-like objects, the
    noise and norm kinds as enums of either package or their values; secure
    and numeric_mode carry across as they are)."""
    fields = dict(fields)
    plan = tuple(
        executor.MetricPlanEntry(kind=e["kind"], outputs=tuple(e["outputs"]),
                                 n_stds=int(e["n_stds"]))
        for e in (_as_dict(entry) for entry in fields.pop("plan")))
    selection = fields.pop("selection")
    noise_kind = fields.pop("noise_kind")
    norm_kind = fields.pop("vector_norm_kind", None)
    return executor.KernelConfig(
        plan=plan,
        selection=(None if selection is None else
                   selection_params(_as_dict(selection))),
        noise_kind=NoiseKind(getattr(noise_kind, "value", noise_kind)),
        vector_norm_kind=(None if norm_kind is None else
                          NormKind(getattr(norm_kind, "value", norm_kind))),
        quantiles=tuple(fields.pop("quantiles", ())),
        **fields)


def noise_stds(stds) -> np.ndarray:
    """Noise stds in plan order, float64."""
    return np.asarray(stds, dtype=np.float64).reshape(-1)


def threefry_key(key) -> np.ndarray:
    """A raw threefry key (uint32[2])."""
    key = np.asarray(key, dtype=np.uint32).reshape(-1)
    if key.shape != (2,):
        raise ValueError(f"a threefry key has two uint32 words, got {key}")
    return key


def row_tensors(pid, pk, values, valid, device, dtype: torch.dtype):
    """Padded row arrays (numpy) as the kernels' tensors."""
    return (torch.as_tensor(np.asarray(pid, dtype=np.int32)).to(device),
            torch.as_tensor(np.asarray(pk, dtype=np.int32)).to(device),
            torch.as_tensor(np.asarray(values)).to(device=device,
                                                    dtype=dtype),
            torch.as_tensor(np.asarray(valid, dtype=bool)).to(device))


def pld(probs, lower_index: int, interval: float,
        infinity_mass: float) -> pldlib.PrivacyLossDistribution:
    """The port's PrivacyLossDistribution from a JAX one's fields (its
    `probs`, `_lower_index`, `interval` and `infinity_mass`)."""
    return pldlib.PrivacyLossDistribution(
        np.array(probs, dtype=np.float64), int(lower_index), float(interval),
        float(infinity_mass))


HISTOGRAM_FIELDS = ("l0_contributions_histogram", "l1_contributions_histogram",
                    "linf_contributions_histogram",
                    "linf_sum_contributions_histogram",
                    "count_per_partition_histogram",
                    "count_privacy_id_per_partition")


def histograms_fields(dataset_histograms) -> Tuple[Optional[tuple], ...]:
    """Either package's DatasetHistograms as plain tuples, one per
    histogram in field order: None, or (type value, ((lower, upper, count,
    sum, max), ...))."""
    out = []
    for field in HISTOGRAM_FIELDS:
        h = getattr(dataset_histograms, field)
        out.append(None if h is None else (h.name.value, tuple(
            (b.lower, b.upper, b.count, b.sum, b.max) for b in h.bins)))
    return tuple(out)


def sweep_config_arrays(cfg) -> "analysis_kernels.SweepConfigArrays":
    """The JAX package's SweepConfigArrays (numpy or jax arrays) as the
    port's, field by field, as float64 numpy arrays."""
    return analysis_kernels.SweepConfigArrays(
        *[np.asarray(x, dtype=np.float64) for x in cfg])


_ENUM_FIELDS = {"noise_kind": "NoiseKind",
                "partition_selection_strategy": "PartitionSelectionStrategy"}


def aggregate_params(agg_module, fields: Mapping[str, Any]):
    """An AggregateParams of the package whose aggregate_params module is
    agg_module, from plain fields: metrics as a list of Metrics names,
    noise_kind and partition_selection_strategy as their enum names, the
    rest as they are."""
    fields = dict(fields)
    if "metrics" in fields:
        fields["metrics"] = [getattr(agg_module.Metrics, m)
                             for m in fields["metrics"]]
    for name, enum in _ENUM_FIELDS.items():
        if name in fields:
            fields[name] = getattr(agg_module, enum)[fields[name]]
    return agg_module.AggregateParams(**fields)


def multi_parameter_configuration(agg_module, data_structures_module,
                                  fields: Mapping[str, Sequence]):
    """A MultiParameterConfiguration of either package from plain fields
    (enum-valued sequences as their names)."""
    fields = dict(fields)
    for name, enum in _ENUM_FIELDS.items():
        if name in fields:
            fields[name] = [getattr(agg_module, enum)[v]
                            for v in fields[name]]
    return data_structures_module.MultiParameterConfiguration(**fields)


def utility_analysis_options(agg_module, data_structures_module, *,
                             epsilon: float, delta: float,
                             params: Mapping[str, Any],
                             multi: Optional[Mapping[str, Sequence]] = None,
                             partitions_sampling_prob: float = 1,
                             pre_aggregated_data: bool = False):
    """UtilityAnalysisOptions of either package (its aggregate_params and
    analysis.data_structures modules) from plain fields."""
    return data_structures_module.UtilityAnalysisOptions(
        epsilon=epsilon,
        delta=delta,
        aggregate_params=aggregate_params(agg_module, params),
        multi_param_configuration=(None if multi is None else
                                   multi_parameter_configuration(
                                       agg_module, data_structures_module,
                                       multi)),
        partitions_sampling_prob=partitions_sampling_prob,
        pre_aggregated_data=pre_aggregated_data)


def tune_options(agg_module, parameter_tuning_module, *, epsilon: float,
                 delta: float, params: Mapping[str, Any],
                 parameters_to_tune: Mapping[str, bool],
                 number_of_parameter_candidates: int = 100,
                 partitions_sampling_prob: float = 1,
                 pre_aggregated_data: bool = False,
                 function_to_minimize: str = "ABSOLUTE_ERROR"):
    """TuneOptions of either package (its aggregate_params and
    analysis.parameter_tuning modules) from plain fields."""
    pt = parameter_tuning_module
    return pt.TuneOptions(
        epsilon=epsilon,
        delta=delta,
        aggregate_params=aggregate_params(agg_module, params),
        function_to_minimize=pt.MinimizingFunction[function_to_minimize],
        parameters_to_tune=pt.ParametersToTune(**dict(parameters_to_tune)),
        partitions_sampling_prob=partitions_sampling_prob,
        pre_aggregated_data=pre_aggregated_data,
        number_of_parameter_candidates=number_of_parameter_candidates)


def _as_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, Mapping):
        return dict(obj)
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}
