// Ordered-statistics decoding of LDPC(174,91) BP failures — native fast
// path for the host OSD stage (rtlsdr_ft8d_jax/ops/osd.py documents the
// algorithm; this implements the same order-1 + partial order-2
// reprocessing with identical selection/acceptance rules so decode lists
// match the Python path bit for bit).
//
// A production wideband window ships up to 1024 failed candidates; each
// OSD is a 91x91 GF(2) elimination plus 70 pattern re-encodes, which is
// exactly the kind of bit-twiddling C++ does two orders of magnitude
// faster than vectorized numpy (VERDICT r2 #3). GF(2) rows live as
// 2xuint64 (91 bits), codewords as 3xuint64 (174 bits).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

#include "ft8_tables.h"

extern "C" uint16_t ft8_crc14(const uint8_t* payload_bits77);

namespace {

constexpr int kN = 174;   // codeword bits
constexpr int kK = 91;    // message bits
constexpr int kP = 77;    // payload bits

// E = [I_91; G] rows packed over the 91 message-bit columns,
// column c -> word c>>6, bit c&63.
struct ETable {
  uint64_t rows[kN][2];
  ETable() {
    memset(rows, 0, sizeof rows);
    for (int i = 0; i < kK; ++i) rows[i][i >> 6] = 1ull << (i & 63);
    for (int m = 0; m < 83; ++m)
      for (int c = 0; c < kK; ++c)
        if ((kGenerator[m][c >> 3] >> (7 - (c & 7))) & 1)
          rows[kK + m][c >> 6] |= 1ull << (c & 63);
  }
};
const ETable kE;

inline int first_bit(const uint64_t w[2]) {
  if (w[0]) return __builtin_ctzll(w[0]);
  if (w[1]) return 64 + __builtin_ctzll(w[1]);
  return -1;
}

inline int parity2(const uint64_t a[2], const uint64_t b[2]) {
  return (__builtin_popcountll(a[0] & b[0]) ^
          __builtin_popcountll(a[1] & b[1])) & 1;
}

// cw = E @ m over GF(2): first 91 bits are m (systematic), parity bits
// from the generator rows.
inline void encode(const uint64_t m[2], uint64_t cw[3]) {
  cw[0] = m[0];
  cw[1] = m[1] & ((1ull << (kK - 64)) - 1);
  cw[2] = 0;
  for (int i = kK; i < kN; ++i)
    if (parity2(kE.rows[i], m)) cw[i >> 6] |= 1ull << (i & 63);
}

struct Shortlist {                  // stable ascending-by-disc top-T
  double disc[16];
  uint64_t cw[16][3];
  int n = 0, cap;
  explicit Shortlist(int t) : cap(t < 16 ? t : 16) {}
  void add(double d, const uint64_t c[3]) {
    int i = n;
    // stable: insert AFTER entries with disc <= d (pattern order wins ties)
    while (i > 0 && disc[i - 1] > d) --i;
    if (i >= cap) return;
    int last = n < cap ? n : cap - 1;
    for (int j = last; j > i; --j) {
      disc[j] = disc[j - 1];
      memcpy(cw[j], cw[j - 1], sizeof cw[j]);
    }
    disc[i] = d;
    memcpy(cw[i], c, sizeof cw[i]);
    if (n < cap) ++n;
  }
};

// One candidate. Returns 1 and writes msg91 when a CRC-valid reprocessed
// codeword exists with normalized discrepancy <= max_norm.
int osd_one(const float* llr, int depth, int pair_depth, int crc_top,
            double max_norm, uint8_t* msg91_out) {
  double rel[kN];
  uint64_t hardp[3] = {0, 0, 0};
  for (int i = 0; i < kN; ++i) {
    rel[i] = std::fabs((double)llr[i]);
    if (llr[i] > 0.0f) hardp[i >> 6] |= 1ull << (i & 63);
  }
  int perm[kN];
  for (int i = 0; i < kN; ++i) perm[i] = i;
  std::stable_sort(perm, perm + kN,
                   [&](int a, int b) { return rel[a] > rel[b]; });

  // greedy most-reliable basis, RREF maintained so reducing a new row is
  // one masked-XOR pass (stored rows have 0 in every other pivot column)
  uint64_t rowsP[kK][2], augP[kK][2];
  bool has_piv[kK] = {false};
  int basis[kK], nbasis = 0;
  for (int j = 0; j < kN && nbasis < kK; ++j) {
    uint64_t r[2] = {kE.rows[perm[j]][0], kE.rows[perm[j]][1]};
    uint64_t a[2] = {0, 0};
    for (int c = 0; c < kK; ++c) {
      if (has_piv[c] && ((r[c >> 6] >> (c & 63)) & 1)) {
        r[0] ^= rowsP[c][0]; r[1] ^= rowsP[c][1];
        a[0] ^= augP[c][0];  a[1] ^= augP[c][1];
      }
    }
    if (!(r[0] | r[1])) continue;                 // dependent row
    a[nbasis >> 6] ^= 1ull << (nbasis & 63);      // + e_slot
    int piv = first_bit(r);
    for (int c = 0; c < kK; ++c) {                // back-eliminate
      if (has_piv[c] && ((rowsP[c][piv >> 6] >> (piv & 63)) & 1)) {
        rowsP[c][0] ^= r[0]; rowsP[c][1] ^= r[1];
        augP[c][0] ^= a[0];  augP[c][1] ^= a[1];
      }
    }
    rowsP[piv][0] = r[0]; rowsP[piv][1] = r[1];
    augP[piv][0] = a[0];  augP[piv][1] = a[1];
    has_piv[piv] = true;
    basis[nbasis++] = perm[j];
  }
  if (nbasis < kK) return 0;

  // base solve m0 = inv @ y0 (aug rows over the slot-ordered hard bits)
  uint64_t y0[2] = {0, 0};
  for (int s = 0; s < kK; ++s)
    if ((hardp[basis[s] >> 6] >> (basis[s] & 63)) & 1)
      y0[s >> 6] |= 1ull << (s & 63);
  uint64_t m0[2] = {0, 0};
  for (int c = 0; c < kK; ++c)
    if (parity2(augP[c], y0)) m0[c >> 6] |= 1ull << (c & 63);
  uint64_t cw0[3];
  encode(m0, cw0);

  // least-reliable basis slots (stable ascending) and their codeword
  // toggle columns: flipping slot s toggles m by inverse column s
  int order[kK];
  for (int s = 0; s < kK; ++s) order[s] = s;
  std::stable_sort(order, order + kK, [&](int x, int y) {
    return rel[basis[x]] < rel[basis[y]];
  });
  uint64_t colcw[32][3];
  int nd = depth < 32 ? depth : 32;
  for (int w = 0; w < nd; ++w) {
    int s = order[w];
    uint64_t icol[2] = {0, 0};
    for (int c = 0; c < kK; ++c)
      if ((augP[c][s >> 6] >> (s & 63)) & 1) icol[c >> 6] |= 1ull << (c & 63);
    encode(icol, colcw[w]);
  }

  // == Python's mean(rel) * N up to summation order (numpy sums
  // pairwise); the norm gate has ulp-level slack vs the numpy path,
  // which the cross-impl parity fuzz tolerates
  double relsum = 0.0;
  for (int i = 0; i < kN; ++i) relsum += rel[i];
  double scale = relsum < 1e-9 ? 1e-9 : relsum;

  // pattern order identical to osd_decode: none, singles, pairs
  Shortlist top(crc_top);
  auto score = [&](const uint64_t cw[3]) {
    double d = 0.0;
    for (int w = 0; w < 3; ++w) {
      uint64_t diff = cw[w] ^ hardp[w];
      while (diff) {
        int b = __builtin_ctzll(diff);
        d += rel[w * 64 + b];
        diff &= diff - 1;
      }
    }
    return d;
  };
  top.add(score(cw0), cw0);
  for (int i = 0; i < nd; ++i) {
    uint64_t cw[3] = {cw0[0] ^ colcw[i][0], cw0[1] ^ colcw[i][1],
                      cw0[2] ^ colcw[i][2]};
    top.add(score(cw), cw);
  }
  int npw = pair_depth < nd ? pair_depth : nd;
  for (int a = 0; a < npw; ++a)
    for (int b = a + 1; b < npw; ++b) {
      uint64_t cw[3] = {cw0[0] ^ colcw[a][0] ^ colcw[b][0],
                        cw0[1] ^ colcw[a][1] ^ colcw[b][1],
                        cw0[2] ^ colcw[a][2] ^ colcw[b][2]};
      top.add(score(cw), cw);
    }

  // first CRC-valid of the shortlist; the norm gate then decides accept
  // (matching osd_decode + osd_batch caller semantics exactly)
  for (int t = 0; t < top.n; ++t) {
    const uint64_t* cw = top.cw[t];
    uint8_t bits[kK];
    bool any = false;
    for (int i = 0; i < kK; ++i) {
      bits[i] = (cw[i >> 6] >> (i & 63)) & 1;
      if (i < kP && bits[i]) any = true;
    }
    if (!any) continue;
    uint16_t crc = ft8_crc14(bits);
    uint16_t got = 0;
    for (int i = kP; i < kK; ++i) got = (uint16_t)((got << 1) | bits[i]);
    if (crc != got) continue;
    if (top.disc[t] / scale > max_norm) return 0;
    memcpy(msg91_out, bits, kK);
    return 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// OSD a batch of failed candidates' LLRs.
//   llrs:      (n, 174) float32, positive = bit 1
//   msgs_out:  (n, 91) uint8 — filled where accepted
//   accept:    (n,) uint8
// Returns the number accepted.
int ft8_osd_batch(const float* llrs, int n, int depth, int pair_depth,
                  int crc_top, double max_norm, uint8_t* msgs_out,
                  uint8_t* accept) {
  int total = 0;
  for (int i = 0; i < n; ++i) {
    accept[i] = (uint8_t)osd_one(llrs + (size_t)i * kN, depth, pair_depth,
                                 crc_top, max_norm, msgs_out + (size_t)i * kK);
    total += accept[i];
  }
  return total;
}

}  // extern "C"
