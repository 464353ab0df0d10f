"""Device placement for the single-GPU path (counterpart: the one-device
subset of fastapriori_tpu/parallel/mesh.py ``DeviceContext`` — upload,
the vertical engine's arena and plane uploads, fetch; no mesh and no
collectives).

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  With no
CUDA device and no such request, :func:`resolve_device` raises
``InputError``: the port never quietly runs on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.ops.vertical import assemble_arena
from fastapriori_tpu_torch.ops.vertical_kernel import lane_plane_mask


def resolve_device(device: Optional[Union[str, torch.device]] = None):
    """``None``/``"cuda"`` -> the current CUDA device (InputError when
    there is none); ``"cpu"`` -> the CPU, where every kernel wrapper runs
    its plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise InputError(
                "no CUDA device is available; this port runs on the GPU "
                "unless asked otherwise (--platform cpu on the CLI, "
                "device='cpu' in the API)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # The pair Gram and the heavy-row corrections are float matmuls
        # that are exact only in full precision (models/apriori.py): keep
        # cuBLAS off TF32 for the process.
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise InputError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


class DeviceContext:
    """One device: host arrays go up with :meth:`upload`, results come
    back with :meth:`fetch`."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)

    @property
    def platform(self) -> str:
        return self.device.type

    def upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def upload_tid_arena(
        self, arena_np: np.ndarray, buckets=None
    ) -> Tuple[torch.Tensor, int]:
        """Place the vertical engine's uint32 ``[f_pad+1, NL]`` arena as
        an int32 tensor with the same bits (the one-device subset of
        fastapriori_tpu/parallel/mesh.py ``upload_tid_arena``).
        ``buckets``: its index-compressed form (ops/vertical.py
        ``compress_arena``), uploaded and scattered into the dense arena
        on the device; None uploads the dense arena.  Returns ``(arena,
        upload_bytes)``."""
        if buckets is None:
            return self.upload(arena_np.view(np.int32)), arena_np.nbytes
        dev = [
            (self.upload(ids), self.upload(segs),
             self.upload(words.view(np.int32)))
            for ids, segs, words in buckets
        ]
        payload = sum(
            ids.nbytes + segs.nbytes + words.nbytes
            for ids, segs, words in buckets
        )
        f_pad = arena_np.shape[0] - 1
        return assemble_arena(dev, f_pad, arena_np.shape[1], self.device), \
            payload

    def upload_lane_planes(self, planes_np: np.ndarray) -> torch.Tensor:
        """The uint32 ``[B, NL]`` weight bit-planes as int32 (the same
        bits), beside the arena; K3's per-lane plane mask is derived from
        them here, once (ops/vertical_kernel.py ``lane_plane_mask``)."""
        planes = self.upload(planes_np.view(np.int32))
        lane_plane_mask(planes)
        return planes

    @staticmethod
    def fetch(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()
