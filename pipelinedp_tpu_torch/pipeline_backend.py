"""TorchBackend: the port's single-device columnar backend.

Port of the dense route of pipelinedp_tpu/pipeline_backend.py TPUBackend.
DPEngine.aggregate and DPEngine.select_partitions on a TorchBackend lower to
the port's executor (executor.lazy_aggregate, lazy_select_partitions): the
dense route, or above large_partition_threshold the blocked route
(parallel/large_p.py), on the port's CUDA kernels on the card. Either entry
point also takes a runtime.pipeline.ChunkSource of column chunks, streamed
through ingest.stream_encode_columns under the backend's pipeline_depth,
encode_threads and encode_mode.
"""

from typing import Optional, Union

import torch

from pipelinedp_tpu_torch import input_validators


class TorchBackend:
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
