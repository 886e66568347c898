// The work plan of paged attention (paged_attention.cu): how many pages a
// block walks, how many blocks cover a slot, and how many merge counters
// a launch needs.  Plain C++ with no CUDA in it, so the host compiler
// alone can build it; ptt_paged_attention_plan reports it.
//
// The plan comes from shapes alone, never from pos (no read of device
// memory on the host, so a launch can be captured in a CUDA graph).  A
// block walks `chunk` pages: keys = chunk * ps is a power of two from
// kMinKeys to kMaxKeys, at least kKeysPerRow per query row of the
// block's tile (its fp32 partial state, written and read back by the
// merge, stays under half the K/V bytes it reads) and at least 512;
// halved while a full table would give fewer than two blocks an SM.
// Block z of a slot takes pages [z * chunk, z * chunk + chunk), so
// splits = ceil(P_slot / chunk) blocks cover the longest slot, and no
// block walks more than `chunk` pages whatever the slot's length.
#pragma once

namespace ptt_paged {

constexpr int kRowTile = 128;   // query rows a tensor-core block
constexpr int kMinKeys = 128;
constexpr int kMaxKeys = 1024;
constexpr int kKeysPerRow = 8;

struct Plan {
  int chunk;     // pages a block walks
  int splits;    // blocks that cover a slot (grid z)
  int counters;  // int32 merge counters a launch needs (0: no merge)
};

// B slots, n_kv kv heads, R = C * group query rows a kv head, tables of
// P_slot pages of ps rows, on a card with `sms` multiprocessors.
inline Plan plan(int B, int n_kv, int R, int P_slot, int ps, int sms) {
  const long long tiles = (R + kRowTile - 1) / kRowTile;
  const long long rows = R < kRowTile ? R : kRowTile;
  const long long min_blocks = 2LL * sms;
  const long long table_keys = static_cast<long long>(P_slot) * ps;
  long long keys = 512;
  while (keys < kMaxKeys && keys < kKeysPerRow * rows) keys *= 2;
  while (keys > kMinKeys &&
         static_cast<long long>(B) * n_kv * tiles *
                 ((table_keys + keys - 1) / keys) <
             min_blocks)
    keys /= 2;
  long long chunk = keys / ps;
  if (chunk > P_slot) chunk = P_slot;
  if (chunk < 1) chunk = 1;
  Plan p;
  p.chunk = static_cast<int>(chunk);
  p.splits = static_cast<int>((P_slot + chunk - 1) / chunk);
  p.counters =
      p.splits > 1 ? static_cast<int>(static_cast<long long>(B) * n_kv * tiles)
                   : 0;
  return p;
}

}  // namespace ptt_paged
