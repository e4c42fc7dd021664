// The flags of the neighbour forms (csrc/resident_family.cu: B1, B4, B5,
// B6; csrc/resident_nbr_batched.cu: K4): a block publishes a step count
// with a release store and its neighbours wait for it with acquire loads.
#pragma once

namespace eu {

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A neighbour is at most one step behind a co-resident block, so a wait of
// seconds means a broken launch: trap (a launch error the wrapper raises)
// rather than hang the card.
__device__ __forceinline__ void wait_flag(const unsigned long long* p, unsigned long long want) {
  int tries = 0;
  while (load_acquire(p) < want) {
    if (++tries > 16) __nanosleep(tries < 64 ? 32 : 128);
    if (tries > (1 << 25)) __trap();
  }
}

// Block b's flag is flags[b kFlagStride]: one flag per 128-byte line. With
// the flags packed, sixteen blocks' releases and their neighbours' polls
// shared a line, and a step cost 0.1-0.2 us more on the H100, depending on
// where the buffer landed (PERF.md).
constexpr int kFlagStride = 16;

}  // namespace eu
