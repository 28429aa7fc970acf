"""Pipeline backends: the generic operation vocabulary and TorchBackend.

Port of pipelinedp_tpu/pipeline_backend.py:48-294 (PipelineBackend, the
~20 generic operations every backend implements, each with a stage name;
UniqueLabelsGenerator; LocalBackend, lazy Python generators) and of the
dense route of its TPUBackend. The annotator registry (:1100-1113) is not
ported: annotate() is the base class's no-op.

TorchBackend is a LocalBackend, as TPUBackend is: the generic vocabulary
runs on the host, so the host utilities (utility analysis, parameter
tuning) run on it. DPEngine.aggregate and DPEngine.select_partitions on a
TorchBackend lower to the port's executor (executor.lazy_aggregate,
lazy_select_partitions): the dense route, or above
large_partition_threshold the blocked route (parallel/large_p.py), on the
port's CUDA kernels on the card. Either entry point also takes a
runtime.pipeline.ChunkSource of column chunks, streamed through
ingest.stream_encode_columns under the backend's pipeline_depth,
encode_threads and encode_mode. Utility analysis on a TorchBackend sweeps
on backend.device in backend.dtype (analysis/kernels.py).
"""

import abc
import collections
import itertools
import operator
import random
from typing import Callable, Iterable, Optional, Union

import torch

from pipelinedp_tpu_torch import input_validators


class PipelineBackend(abc.ABC):
    """Interface implemented by all execution backends."""

    def to_collection(self, collection_or_iterable, col, stage_name: str):
        """Converts an iterable to the backend-native collection."""
        del col, stage_name
        return collection_or_iterable

    def to_multi_transformable_collection(self, col):
        """Returns a collection that can be iterated multiple times."""
        return col

    @abc.abstractmethod
    def map(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def map_with_side_inputs(self, col, fn, side_input_cols, stage_name: str):
        """fn(row, *side_inputs) where each side input collection is
        materialized and passed as one object."""

    @abc.abstractmethod
    def flat_map(self, col, fn, stage_name: str):
        pass

    def flat_map_with_side_inputs(self, col, fn, side_input_cols,
                                  stage_name: str):
        raise NotImplementedError(
            f"flat_map_with_side_inputs is not supported in "
            f"{type(self).__name__}")

    @abc.abstractmethod
    def map_tuple(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def map_values(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def group_by_key(self, col, stage_name: str):
        """(key, value) -> (key, iterable-of-values)."""

    @abc.abstractmethod
    def filter(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def filter_by_key(self, col, keys_to_keep, stage_name: str):
        """Keeps only (key, data) whose key is in keys_to_keep (local list/set
        or distributed collection)."""

    @abc.abstractmethod
    def keys(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def values(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def sample_fixed_per_key(self, col, n: int, stage_name: str):
        """(key, value) -> (key, [<=n uniformly sampled values])."""

    @abc.abstractmethod
    def count_per_element(self, col, stage_name: str):
        """element -> (element, count)."""

    @abc.abstractmethod
    def sum_per_key(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def combine_accumulators_per_key(self, col,
                                     combiner: 'combiners.Combiner',
                                     stage_name: str):
        """Merges all accumulators per key with combiner.merge_accumulators."""

    @abc.abstractmethod
    def reduce_per_key(self, col, fn: Callable, stage_name: str):
        """Reduces values per key with an associative commutative fn."""

    @abc.abstractmethod
    def flatten(self, cols: Iterable, stage_name: str):
        """Union of several collections."""

    @abc.abstractmethod
    def distinct(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def to_list(self, col, stage_name: str):
        """1-element collection holding the list of all elements."""

    def annotate(self, col, stage_name: str, **kwargs):
        """Applies all registered annotators (no-op by default)."""
        return col


class UniqueLabelsGenerator:
    """Generates unique stage labels (needed by Beam transform naming)."""

    def __init__(self, suffix):
        self._labels = set()
        self._suffix = ("_" + suffix) if suffix else ""

    def _add_if_unique(self, label):
        if label in self._labels:
            return False
        self._labels.add(label)
        return True

    def unique(self, label):
        if not label:
            label = "UNDEFINED_STAGE_NAME"
        suffix_label = label + self._suffix
        if self._add_if_unique(suffix_label):
            return suffix_label
        for i in itertools.count(1):
            label_candidate = f"{label}_{i}{self._suffix}"
            if self._add_if_unique(label_candidate):
                return label_candidate


class LocalBackend(PipelineBackend):
    """Lazy single-machine backend over Python generators.

    Ground-truth semantics for every other backend (the JAX package's
    LocalBackend, pipeline_backend.py:170-297, operation for operation).
    Each operation returns a lazy generator that runs when iterated, once;
    to_multi_transformable_collection materializes a collection that can
    be iterated again. `seed` seeds sample_fixed_per_key's random.Random,
    so the same seed samples the same values as the JAX package's
    LocalBackend(seed=...).
    """

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def to_multi_transformable_collection(self, col):
        return list(col)

    def map(self, col, fn, stage_name: str = None):
        return (fn(x) for x in col)

    def map_with_side_inputs(self, col, fn, side_input_cols, stage_name=None):
        side_inputs = [list(s) for s in side_input_cols]

        def gen():
            for x in col:
                yield fn(x, *side_inputs)

        return gen()

    def flat_map(self, col, fn, stage_name: str = None):
        return (x for el in col for x in fn(el))

    def flat_map_with_side_inputs(self, col, fn, side_input_cols,
                                  stage_name=None):
        side_inputs = [list(s) for s in side_input_cols]

        def gen():
            for el in col:
                yield from fn(el, *side_inputs)

        return gen()

    def map_tuple(self, col, fn, stage_name: str = None):
        return (fn(*x) for x in col)

    def map_values(self, col, fn, stage_name: str = None):
        return ((k, fn(v)) for k, v in col)

    def group_by_key(self, col, stage_name: str = None):

        def gen():
            d = collections.defaultdict(list)
            for key, value in col:
                d[key].append(value)
            yield from d.items()

        return gen()

    def filter(self, col, fn, stage_name: str = None):
        return (x for x in col if fn(x))

    def filter_by_key(self, col, keys_to_keep, stage_name: str = None):

        def gen():
            keys = keys_to_keep if isinstance(keys_to_keep,
                                              (set, frozenset, dict)) else set(
                                                  keys_to_keep)
            for key, value in col:
                if key in keys:
                    yield key, value

        return gen()

    def keys(self, col, stage_name: str = None):
        return (k for k, _ in col)

    def values(self, col, stage_name: str = None):
        return (v for _, v in col)

    def sample_fixed_per_key(self, col, n: int, stage_name: str = None):

        def gen():
            for key, values in self.group_by_key(col):
                if len(values) > n:
                    values = self._rng.sample(values, n)
                yield key, values

        return gen()

    def count_per_element(self, col, stage_name: str = None):

        def gen():
            yield from collections.Counter(col).items()

        return gen()

    def sum_per_key(self, col, stage_name: str = None):
        return self.reduce_per_key(col, operator.add, stage_name)

    def combine_accumulators_per_key(self, col,
                                     combiner: 'combiners.Combiner',
                                     stage_name: str = None):
        return self.reduce_per_key(col, combiner.merge_accumulators, stage_name)

    def reduce_per_key(self, col, fn: Callable, stage_name: str = None):

        def gen():
            d = {}
            for key, value in col:
                d[key] = fn(d[key], value) if key in d else value
            yield from d.items()

        return gen()

    def flatten(self, cols, stage_name: str = None):
        return itertools.chain(*cols)

    def distinct(self, col, stage_name: str = None):

        def gen():
            yield from set(col)

        return gen()

    def to_list(self, col, stage_name: str = None):
        return iter([list(col)])



class TorchBackend(LocalBackend):
    """Runs DP aggregations through the port's kernels on one device.

    Args:
      device: "cuda" (the default) or "cpu". The CPU runs each kernel's
        plain PyTorch version and exists for the tests. With no device
        given, a machine without CUDA raises: the backend never moves to
        the CPU on its own.
      noise_seed: seeds every random choice of a release (None: fresh).
        The same seed releases the same partitions and noise words as
        pipelinedp_tpu.TPUBackend(noise_seed=...).
      large_partition_threshold: above this many partitions both entry
        points take the blocked route (parallel/large_p.py): the partition
        axis runs in blocks of block_partitions, and only kept partitions
        leave the device. None: the dense route for every partition count.
      dtype: the working float width: torch.float32 (the card's mode) or
        torch.float64 (parity with the JAX package under x64).
      secure_noise: release every noised column on a power-of-two grid
        with discrete noise drawn from 64-bit inverse-CDF tables
        (ops/secure_noise.py), as TPUBackend(secure_noise=True) does.
      numeric_mode: "fast" (the default) or "safe": float32 partition sums
        carried as compensated (TwoSum hi, lo) pairs, exact for
        integer-valued sums to ~2^48, and a release sentinel that raises
        NumericOverflowError on Inf or saturation.
      snap_grid_bits: floors the secure-noise grid at 2**snap_grid_bits
        (None: the tables' own grid).
      block_partitions: partitions per block of the blocked route (None:
        the blocked route's default, 2^20), as
        TPUBackend(block_partitions=...).
      max_partitions: a fixed result width, as
        TPUBackend(max_partitions=...): the release runs over this many
        partitions (the ones past the data's emit nothing) and raises
        ValueError when the data has more. It counts before the route is
        chosen.
      pipeline_depth: chunks a streamed input keeps in flight (None: the
        shared runtime.pipeline.PIPELINE_DEPTH).
      encode_threads: host threads encoding a streamed input's chunks (0:
        one loop; None: runtime.pipeline.default_encode_threads()).
      encode_mode: how a streamed input's keys are encoded: "host" (the
        exact chunked vocabulary encoder) or "hash_device" (keys hashed on
        the host, codes assigned on the device, partition keys decoded
        only where kept). A ChunkSource's own encode_mode overrides it.

    The generic operations are LocalBackend's, seeded by noise_seed, as
    TPUBackend's are.
    """

    def __init__(self,
                 device: Union[str, torch.device, None] = None,
                 noise_seed: Optional[int] = None,
                 large_partition_threshold: Optional[int] = 1 << 21,
                 dtype: torch.dtype = torch.float32,
                 secure_noise: bool = False,
                 numeric_mode: str = "fast",
                 snap_grid_bits: Optional[int] = None,
                 block_partitions: Optional[int] = None,
                 max_partitions: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 encode_threads: Optional[int] = None,
                 encode_mode: str = "host"):
        super().__init__(seed=noise_seed)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: CUDA is not available. The port runs on "
                    "the card; pass device='cpu' explicitly to run the "
                    "kernels' plain versions.")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchBackend: device {device} requested but "
                               f"CUDA is not available.")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchBackend: unsupported device {device}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"TorchBackend: dtype must be torch.float32 or "
                             f"torch.float64, got {dtype}")
        input_validators.validate_numeric_mode(numeric_mode, "TorchBackend")
        if snap_grid_bits is not None:
            input_validators.validate_snap_grid_bits(snap_grid_bits,
                                                     "TorchBackend")
        if block_partitions is not None:
            input_validators.validate_block_partitions(block_partitions,
                                                       "TorchBackend")
        if pipeline_depth is not None:
            input_validators.validate_pipeline_depth(pipeline_depth,
                                                     "TorchBackend")
        if encode_threads is not None:
            input_validators.validate_encode_threads(encode_threads,
                                                     "TorchBackend")
        input_validators.validate_encode_mode(encode_mode, "TorchBackend")
        self.device = device
        self.noise_seed = noise_seed
        self.large_partition_threshold = large_partition_threshold
        self.dtype = dtype
        self.secure_noise = secure_noise
        self.numeric_mode = numeric_mode
        self.snap_grid_bits = snap_grid_bits
        self.block_partitions = block_partitions
        self.max_partitions = max_partitions
        self.pipeline_depth = pipeline_depth
        self.encode_threads = encode_threads
        self.encode_mode = encode_mode
