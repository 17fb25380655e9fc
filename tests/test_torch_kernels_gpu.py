"""The CUDA kernels against their plain versions on a card (``gpu`` marker;
skipped where ``torch.cuda.is_available()`` is false). Imports no JAX, so it
runs on a machine that has only PyTorch and the CUDA toolkit:
``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import combine_update as cu
from repro_torch.kernels.chunked_copy import chunked_copy, chunked_copy_plain


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cur = torch.randn((7, 1029), generator=gen, device="cuda").to(dt)
    recv = torch.randn((7, 1029), generator=gen, device="cuda").to(dt)
    mode = torch.tensor([[0], [1], [2], [0], [2], [1], [0]], dtype=torch.int32, device="cuda")
    cur[0, 0] = -0.0
    cur[3, 1] = float("nan")
    k = cu.fused_combine(cur.clone(), recv, mode)
    p = cu.fused_combine_plain(cur.clone(), recv, mode)
    bits = {2: torch.int16, 4: torch.int32}[cur.element_size()]
    assert torch.equal(k.view(bits), p.view(bits))

    buf = torch.randn((3, 5, 1024), generator=gen, device="cuda").to(dt)
    rv = torch.randn((3, 2, 1024), generator=gen, device="cuda").to(dt)
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    args = (ints([0, 3, 1]), ints([0, 1, 0]), ints([2, 2, 0]))
    for combine in (0, 1):
        k = cu.fused_combine_update(buf.clone(), rv, *args, combine)
        p = cu.fused_combine_update_plain(buf.clone(), rv, *args, combine)
        assert torch.equal(k.view(bits), p.view(bits))

    x = torch.randn(100_003, generator=gen, device="cuda").to(dt)
    for v in (x, x[1:]):
        assert torch.equal(chunked_copy(v).view(bits), chunked_copy_plain(v).view(bits))
    torch.cuda.synchronize()
