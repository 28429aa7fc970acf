"""Pre-aggregation of raw datasets for cheap repeated analysis.

Capability parity with the reference ``analysis/pre_aggregation.py:19-61``.

Port of pipelinedp_tpu/analysis/pre_aggregation.py.
"""

from pipelinedp_tpu_torch import data_extractors as extractors
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.analysis import contribution_bounders as analysis_bounders


def preaggregate(col,
                 backend: pipeline_backend.PipelineBackend,
                 data_extractors: extractors.DataExtractors,
                 partitions_sampling_prob: float = 1):
    """Pre-aggregates a collection.

    Output elements are (partition_key, (count, sum, n_partitions,
    n_contributions)) — one per (privacy_id, partition_key) pair present in
    the dataset. When partitions_sampling_prob < 1, partitions are sampled
    deterministically by key.
    """
    col = backend.map(
        col, lambda row: (data_extractors.privacy_id_extractor(row),
                          data_extractors.partition_extractor(row),
                          data_extractors.value_extractor(row)),
        "Extract (privacy_id, partition_key, value)")
    bounder = analysis_bounders.AnalysisContributionBounder(
        partitions_sampling_prob)
    col = bounder.bound_contributions(col,
                                      params=None,
                                      backend=backend,
                                      report_generator=None,
                                      aggregate_fn=lambda x: x)
    # ((privacy_id, partition_key), (count, sum, n_partitions,
    #   n_contributions))
    return backend.map(col, lambda row: (row[0][1], row[1]),
                       "Drop privacy id")
