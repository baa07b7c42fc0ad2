"""Serving runtime of the PyTorch port: design cache + batched, bucketed
execution on one device.

``DesignCache`` memoizes ranker output and built runners (the analogue of
reusing one FPGA bitstream across invocations); ``build_batched_runner``
runs a batch of independent grids through the tile kernels K1/K2;
``ShapeBucketer`` + ``build_bucket_runner`` + ``DesignCache.bucketed`` let
one logical kernel registration serve heterogeneous grid shapes from a
small ladder of padded bucket designs, under any boundary mode (streamed
mask, halo-index maps, or host-streamed periodic wrap margins).
:mod:`repro_torch.serve.engine` builds the request-facing server on these
pieces.  ``DesignStore`` persists rankings, the CUDA kernel's built
library and serving telemetry across processes
(:mod:`repro_torch.runtime.store`).
"""
from repro_torch.runtime.batching import (
    DegradedDesignWarning,
    build_batched_runner,
    build_bucket_runner,
    validate_batch,
)
from repro_torch.runtime.bucketing import (
    BucketPlan,
    ShapeBucketer,
    boundary_fill,
    bucket_margins,
    bucket_plan,
    bucket_spec,
    check_bucketable,
    grid_mask_host,
    halo_index_host,
    halo_index_names,
    mask_input_name,
    masked_spec,
    pad_batch,
    pad_grid,
    padded_request_shape,
    with_shape,
    wrap_index_host,
    wrap_index_names,
)
from repro_torch.runtime.cache import (
    BucketEntry,
    BucketedDesign,
    BucketStats,
    CachedDesign,
    DesignCache,
    default_cache,
    spec_fingerprint,
    structural_fingerprint,
)
from repro_torch.runtime.store import (
    DesignStore,
    StoreStats,
    environment_tag,
    merge_counters,
    subtract_counters,
)

__all__ = [
    "DegradedDesignWarning",
    "build_batched_runner",
    "build_bucket_runner",
    "validate_batch",
    "BucketPlan",
    "ShapeBucketer",
    "boundary_fill",
    "bucket_margins",
    "bucket_plan",
    "bucket_spec",
    "check_bucketable",
    "grid_mask_host",
    "halo_index_host",
    "halo_index_names",
    "mask_input_name",
    "masked_spec",
    "pad_batch",
    "pad_grid",
    "padded_request_shape",
    "with_shape",
    "wrap_index_host",
    "wrap_index_names",
    "BucketEntry",
    "BucketedDesign",
    "BucketStats",
    "CachedDesign",
    "DesignCache",
    "default_cache",
    "spec_fingerprint",
    "structural_fingerprint",
    "DesignStore",
    "StoreStats",
    "environment_tag",
    "merge_counters",
    "subtract_counters",
]
