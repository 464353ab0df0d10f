"""Serving tier, one process (counterpart: fastapriori_tpu/serve/).

- :class:`~fastapriori_tpu_torch.serve.state.ServingState`: the
  checkpointable model with its rule table mounted on the device (build,
  save, load, recommend_batch, release).
- :class:`~fastapriori_tpu_torch.serve.server.RecommendServer`: the
  request loop: bounded admission with recorded sheds, micro-batching
  behind the batch-rows and linger knobs, the two-stage pack/scan
  dispatcher, barrier-ordered hot swap.
- :mod:`~fastapriori_tpu_torch.serve.loadgen`: seeded open-loop load.
- :class:`~fastapriori_tpu_torch.serve.router.MeshRouter` over
  in-process :class:`~fastapriori_tpu_torch.serve.router.LocalHost`\\ s
  and worker-process
  :class:`~fastapriori_tpu_torch.serve.router.ProcHost`\\ s (``python -m
  fastapriori_tpu_torch.serve.router --worker``, one card each through
  ``CUDA_VISIBLE_DEVICES``): routing with spill, global shed, mesh swap,
  host loss, merged metrics.
"""

from fastapriori_tpu_torch.serve.loadgen import (  # noqa: F401
    arrival_offsets,
    percentiles_ms,
    run_open_loop,
)
from fastapriori_tpu_torch.serve.router import (  # noqa: F401
    LocalHost,
    MeshRouter,
    ProcHost,
)
from fastapriori_tpu_torch.serve.server import (  # noqa: F401
    RecommendServer,
    ServeRequest,
)
from fastapriori_tpu_torch.serve.state import (  # noqa: F401
    SERVING_NAME,
    ServingState,
    model_signature,
)
