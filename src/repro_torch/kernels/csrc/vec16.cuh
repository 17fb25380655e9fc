// 16-byte vector helpers shared by the kernels that move spans at any
// alignment (inkernel_rdma.cu, chunked_copy.cu).
//
// An aligned 16-byte store whose source bytes start `off` bytes past a
// 16-byte boundary is built from the two aligned source vectors around it:
// `funnel` picks the 16 bytes at offset off = 4q + r of the 32 bytes (a, b)
// with prmt on neighbouring 32-bit words, and `shfl_down` hands each lane
// its right neighbour's vector (the warp's last lane loads its own), so a
// warp issues 33 aligned loads for 32 aligned stores.
#pragma once

#include <cuda_runtime.h>

// The 16 bytes at byte offset 4q + r of the 32 bytes (a, b), as prmt
// selector sel = 0x3210 + 0x1111 r picks them from two neighbouring words.
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, int q, unsigned sel) {
  const unsigned w0 = q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
  const unsigned w1 = q == 0 ? a.y : q == 1 ? a.z : q == 2 ? a.w : b.x;
  const unsigned w2 = q == 0 ? a.z : q == 1 ? a.w : q == 2 ? b.x : b.y;
  const unsigned w3 = q == 0 ? a.w : q == 1 ? b.x : q == 2 ? b.y : b.z;
  const unsigned w4 = q == 0 ? b.x : q == 1 ? b.y : q == 2 ? b.z : b.w;
  return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                    __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
}

__device__ __forceinline__ uint4 shfl_down(uint4 v) {
  return make_uint4(__shfl_down_sync(~0u, v.x, 1), __shfl_down_sync(~0u, v.y, 1),
                    __shfl_down_sync(~0u, v.z, 1), __shfl_down_sync(~0u, v.w, 1));
}
