// FT8 protocol codec — native C++ implementation.
//
// Role-equivalent of the reference's vendored ft8_lib (kgoba/ft8_lib git
// submodule, consumed at /root/reference/rtlsdr_ft8d.c:38-44): CRC-14,
// LDPC(174,91) systematic encode, Gray/Costas tone mapping, pack77/unpack77
// message grammar. Exposed with a C ABI for ctypes (pybind11 is not in this
// image). The Python implementation (rtlsdr_ft8d_jax/protocol/) is the
// reference; tests assert byte-parity between the two.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "ft8_tables.h"

namespace {

constexpr int kPayloadBits = 77;
constexpr int kCrcBits = 14;
constexpr int kMsgBits = 91;
constexpr int kCwBits = 174;
constexpr int kNN = 79;
constexpr uint16_t kCrcPoly = 0x2757;

const char kA1[] = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ";
const char kA2[] = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ";
const char kA3[] = "0123456789";
const char kA4[] = " ABCDEFGHIJKLMNOPQRSTUVWXYZ";
const char kFreeText[] = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?";
const char kHashAlpha[] = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/";

constexpr uint32_t kNTokens = 2063592;
constexpr uint32_t kMax22 = 4194304;
constexpr uint32_t kMaxGrid4 = 32400;

int index_of(const char* alpha, char c) {
  const char* p = strchr(alpha, c);
  return p ? static_cast<int>(p - alpha) : -1;
}

// --- bit helpers (MSB-first bit arrays) -----------------------------------
void set_bits(uint8_t* bits, int pos, uint64_t value, int n) {
  for (int i = 0; i < n; ++i)
    bits[pos + i] = (value >> (n - 1 - i)) & 1;
}

uint64_t get_bits(const uint8_t* bits, int pos, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 1) | (bits[pos + i] & 1);
  return v;
}

uint16_t crc14_bits(const uint8_t* bits, int nbits) {
  uint16_t reg = 0;
  for (int i = 0; i < nbits; ++i) {
    reg ^= static_cast<uint16_t>(bits[i] & 1) << (kCrcBits - 1);
    if (reg & (1u << (kCrcBits - 1)))
      reg = ((reg << 1) ^ kCrcPoly) & 0x3FFF;
    else
      reg = (reg << 1) & 0x3FFF;
  }
  return reg;
}

// --- callsign / grid field codecs -----------------------------------------
uint64_t hash_call(const char* call, int nbits) {
  char buf[12];
  int n = 0;
  for (const char* p = call; *p && n < 11; ++p) buf[n++] = toupper(*p);
  while (n < 11) buf[n++] = ' ';
  uint64_t acc = 0;
  for (int i = 0; i < 11; ++i) {
    int idx = index_of(kHashAlpha, buf[i]);
    acc = acc * 38 + (idx < 0 ? 0 : idx);
  }
  uint64_t h = acc * 47055833459ULL;
  return h >> (64 - nbits);
}

// Normalize a standard callsign into the 6-char template; returns false if
// nonstandard.
bool normalize_std(const char* call, char out[7]) {
  char c[8];
  int n = 0;
  for (const char* p = call; *p && n < 7; ++p) c[n++] = toupper(*p);
  c[n] = 0;
  if (n < 2 || n > 6 || strchr(c, '/')) return false;
  char padded[7];
  if (n >= 3 && isdigit(c[2])) {
    snprintf(padded, sizeof padded, "%-6s", c);
  } else if (n >= 2 && n <= 5 && isdigit(c[1])) {
    // space-prefixed form fits only 5 input chars; 6 would truncate
    char tmp[8];
    snprintf(tmp, sizeof tmp, " %s", c);
    snprintf(padded, sizeof padded, "%-6s", tmp);
  } else {
    return false;
  }
  if (index_of(kA1, padded[0]) < 0 || index_of(kA2, padded[1]) < 0 ||
      index_of(kA3, padded[2]) < 0)
    return false;
  for (int i = 3; i < 6; ++i)
    if (index_of(kA4, padded[i]) < 0) return false;
  memcpy(out, padded, 7);
  return true;
}

// defined below inside the extern "C" block (language linkage must match)
extern "C" bool is_nonstd_call(const char* tok);

int64_t pack_c28(const char* field) {
  if (!strcmp(field, "DE")) return 0;
  if (!strcmp(field, "QRZ")) return 1;
  if (!strcmp(field, "CQ")) return 2;
  if (!strncmp(field, "CQ ", 3)) {
    const char* tail = field + 3;
    size_t len = strlen(tail);
    bool digits = len == 3, letters = len >= 1 && len <= 4;
    for (const char* p = tail; *p; ++p) {
      digits = digits && isdigit(*p);
      letters = letters && isalpha(*p);
    }
    if (digits) return 3 + atoi(tail);
    if (letters) {
      uint32_t m = 0;
      for (const char* p = tail; *p; ++p) m = m * 27 + (*p - 'A' + 1);
      return 1003 + m;
    }
    return -1;
  }
  char std6[7];
  if (normalize_std(field, std6)) {
    uint64_t n = index_of(kA1, std6[0]);
    n = n * 36 + index_of(kA2, std6[1]);
    n = n * 10 + index_of(kA3, std6[2]);
    n = n * 27 + index_of(kA4, std6[3]);
    n = n * 27 + index_of(kA4, std6[4]);
    n = n * 27 + index_of(kA4, std6[5]);
    return kNTokens + kMax22 + n;
  }
  // Hash fallback only for valid hashable calls (shared predicate with
  // the Python packer): hashing junk fields (empty strings, bare '/R')
  // made structured parses lossy and the two codecs diverge.
  if (is_nonstd_call(field)) return kNTokens + hash_call(field, 22);
  return -1;
}

bool pack_g15(const char* field, int* g15, int* ir) {
  *ir = 0;
  char buf[32];
  snprintf(buf, sizeof buf, "%s", field);
  char* f = buf;
  size_t len = strlen(f);
  if (len >= 2 && f[0] == 'R' && f[1] == ' ') {
    *ir = 1;
    f += 2;
    len -= 2;
  } else if (len >= 3 && f[0] == 'R' && (f[1] == '+' || f[1] == '-')) {
    *ir = 1;
    f += 1;
    len -= 1;
  }
  if (len == 0) { *g15 = kMaxGrid4 + 1; return true; }
  if (!strcmp(f, "RRR")) { *g15 = kMaxGrid4 + 2; return true; }
  if (!strcmp(f, "RR73")) { *g15 = kMaxGrid4 + 3; return true; }
  if (!strcmp(f, "73")) { *g15 = kMaxGrid4 + 4; return true; }
  if ((len == 4 || len == 6) && f[0] >= 'A' && f[0] <= 'R' && f[1] >= 'A' &&
      f[1] <= 'R' && isdigit(f[2]) && isdigit(f[3])) {
    *g15 = ((f[0] - 'A') * 18 + (f[1] - 'A')) * 100 + (f[2] - '0') * 10 +
           (f[3] - '0');
    return true;
  }
  if ((f[0] == '+' || f[0] == '-') && len >= 2 && len <= 3) {
    bool digits = true;
    for (const char* p = f + 1; *p; ++p) digits = digits && isdigit(*p);
    // digit check: atoi("-D") == 0 used to accept junk as a +00 report
    // (Python requires digits; fuzz_extended caught the divergence)
    if (digits) {
      int rpt = atoi(f);
      if (rpt >= -30 && rpt <= 99) {
        *g15 = kMaxGrid4 + 35 + rpt;
        return true;
      }
    }
  }
  return false;
}

// Returns false on reserved tokens / out-of-range standard-call indices
// (matching the Python unpacker's UnpackError semantics).
bool unpack_c28(uint32_t n28, int ip, int i3, char* out, size_t cap) {
  if (n28 < kNTokens) {
    if (n28 == 0) { snprintf(out, cap, "DE"); return true; }
    if (n28 == 1) { snprintf(out, cap, "QRZ"); return true; }
    if (n28 == 2) { snprintf(out, cap, "CQ"); return true; }
    if (n28 <= 1002) { snprintf(out, cap, "CQ %03u", n28 - 3); return true; }
    if (n28 <= 532443) {
      uint32_t m = n28 - 1003;
      char letters[5]; int n = 0;
      while (m && n < 4) { letters[n++] = 'A' + (m % 27) - 1; m /= 27; }
      char rev[5];
      for (int i = 0; i < n; ++i) rev[i] = letters[n - 1 - i];
      rev[n] = 0;
      snprintf(out, cap, "CQ %s", rev);
      return true;
    }
    return false;                       // reserved token range
  }
  if (n28 < kNTokens + kMax22) {
    snprintf(out, cap, "<...>");
    return true;
  }
  uint64_t n = n28 - kNTokens - kMax22;
  char c6 = kA4[n % 27]; n /= 27;
  char c5 = kA4[n % 27]; n /= 27;
  char c4 = kA4[n % 27]; n /= 27;
  char c3 = kA3[n % 10]; n /= 10;
  char c2 = kA2[n % 36]; n /= 36;
  if (n >= strlen(kA1)) return false;   // bad standard callsign index
  char c1 = kA1[n];
  char buf[8] = {c1, c2, c3, c4, c5, c6, 0};
  // trim
  char* s = buf;
  while (*s == ' ') ++s;
  char* e = s + strlen(s);
  while (e > s && e[-1] == ' ') *--e = 0;
  snprintf(out, cap, "%s%s", s, ip ? (i3 == 2 ? "/P" : "/R") : "");
  return true;
}

void unpack_g15(int g15, int ir, char* out, size_t cap) {
  if (g15 <= static_cast<int>(kMaxGrid4)) {
    int g = g15;
    char c1 = 'A' + g / 1800; g %= 1800;
    char c2 = 'A' + g / 100;  g %= 100;
    char grid[5] = {c1, c2, static_cast<char>('0' + g / 10),
                    static_cast<char>('0' + g % 10), 0};
    snprintf(out, cap, "%s%s", ir ? "R " : "", grid);
    return;
  }
  int irpt = g15 - kMaxGrid4;
  const char* fixed[] = {"", "", "RRR", "RR73", "73"};
  if (irpt >= 1 && irpt <= 4) {
    if (irpt == 1) { out[0] = 0; return; }
    snprintf(out, cap, "%s%s", ir ? "R " : "", fixed[irpt]);
    return;
  }
  snprintf(out, cap, "%s%+03d", ir ? "R" : "", irpt - 35);
}

}  // namespace

extern "C" {

// CRC-14 of the 77 payload bits (zero-padded to 82), like ft8_lib.
uint16_t ft8_crc14(const uint8_t* payload_bits77) {
  uint8_t padded[82];
  memcpy(padded, payload_bits77, 77);
  memset(padded + 77, 0, 5);
  return crc14_bits(padded, 82);
}

// 77 payload bits -> 79 tones (adds CRC, LDPC parity, Gray map, Costas).
void ft8_encode_tones(const uint8_t* payload_bits77, uint8_t* tones79) {
  uint8_t msg[kMsgBits];
  memcpy(msg, payload_bits77, kPayloadBits);
  uint16_t crc = ft8_crc14(payload_bits77);
  set_bits(msg, kPayloadBits, crc, kCrcBits);

  uint8_t cw[kCwBits];
  memcpy(cw, msg, kMsgBits);
  for (int m = 0; m < 83; ++m) {
    uint8_t parity = 0;
    for (int k = 0; k < kMsgBits; ++k) {
      uint8_t gbit = (kGenerator[m][k >> 3] >> (7 - (k & 7))) & 1;
      parity ^= gbit & msg[k];
    }
    cw[kMsgBits + m] = parity;
  }

  static const int kCostasPos[3] = {0, 36, 72};
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 7; ++k) tones79[kCostasPos[c] + k] = kCostas[k];
  for (int d = 0; d < 58; ++d) {
    int sym = d + (d < 29 ? 7 : 14);
    int v = cw[3 * d] * 4 + cw[3 * d + 1] * 2 + cw[3 * d + 2];
    tones79[sym] = kGrayMap[v];
  }
}

// Number of unsatisfied LDPC checks for a 174-bit hard decision.
int ft8_ldpc_check(const uint8_t* cw174) {
  int errors = 0;
  for (int m = 0; m < 83; ++m) {
    int x = 0;
    for (int j = 0; j < kLdpcNumRows[m]; ++j) x ^= cw174[kLdpcNm[m][j]] & 1;
    errors += x;
  }
  return errors;
}

namespace {

// Type 0.1 DXpedition: "TO RR73; DE <HASH> +NN" -> c28 c28 h10 r5
bool try_pack_dxpedition(char toks[8][16], int ntok, uint8_t* bits) {
  if (ntok != 5 || strcmp(toks[1], "RR73;")) return false;
  const char* hc = toks[3];
  size_t hl = strlen(hc);
  if (hl < 3 || hc[0] != '<' || hc[hl - 1] != '>') return false;
  const char* rpt = toks[4];
  if (!(rpt[0] == '+' || rpt[0] == '-')) return false;
  int report = atoi(rpt);
  if (report < -30 || report > 32 || report % 2) return false;
  char s6[7];
  if (!normalize_std(toks[0], s6) || !normalize_std(toks[2], s6))
    return false;
  int64_t a = pack_c28(toks[0]), b = pack_c28(toks[2]);
  if (a < 0 || b < 0) return false;
  char inner[16];
  snprintf(inner, sizeof inner, "%.*s", static_cast<int>(hl - 2), hc + 1);
  uint64_t h10 = hash_call(inner, 10);
  set_bits(bits, 0, a, 28);
  set_bits(bits, 28, b, 28);
  set_bits(bits, 56, h10, 10);
  set_bits(bits, 66, (report + 30) / 2, 5);
  set_bits(bits, 71, 1, 3);
  set_bits(bits, 74, 0, 3);
  return true;
}

// Type 3 RTTY RU: "[TU;] A B [R] 5N9 NNNN" -> t1 c28 c28 R1 r3 s13
bool try_pack_rtty(char toks[8][16], int ntok, uint8_t* bits) {
  int i = 0, tu = 0;
  if (ntok >= 1 && !strcmp(toks[0], "TU;")) { tu = 1; i = 1; }
  int rem = ntok - i;
  if (rem != 4 && rem != 5) return false;
  const char* serial = toks[ntok - 1];
  const char* rpt = toks[ntok - 2];
  int ir = 0;
  if (rem == 5) {
    if (strcmp(toks[ntok - 3], "R")) return false;
    ir = 1;
  }
  for (const char* p = serial; *p; ++p)
    if (!isdigit(*p)) return false;
  int sv = atoi(serial);
  if (sv >= 8000) return false;
  if (strlen(rpt) != 3 || rpt[0] != '5' || rpt[2] != '9'
      || !isdigit(rpt[1]) || rpt[1] < '2') return false;
  char s6[7];
  if (!normalize_std(toks[i], s6) || !normalize_std(toks[i + 1], s6))
    return false;
  int64_t a = pack_c28(toks[i]), b = pack_c28(toks[i + 1]);
  if (a < 0 || b < 0) return false;
  bits[0] = tu;
  set_bits(bits, 1, a, 28);
  set_bits(bits, 29, b, 28);
  bits[57] = ir;
  set_bits(bits, 58, rpt[1] - '0' - 2, 3);
  set_bits(bits, 61, sv, 13);
  set_bits(bits, 74, 3, 3);
  return true;
}

// Type 0.3/0.4 (ARRL Field Day): "A B [R] <ntx><class> <section>"
// -> c28 c28 R1 n4 k3 S7 (protocol/pack.py:_try_pack_fieldday).
bool try_pack_fieldday(char toks[8][16], int ntok, uint8_t* bits) {
  if (ntok < 4) return false;
  const char* section = toks[ntok - 1];
  int s7 = -1;
  for (int i = 0; i < kNumSections; ++i)
    if (!strcmp(section, kArrlSections[i])) { s7 = i + 1; break; }
  if (s7 < 0) return false;
  const char* exch = toks[ntok - 2];
  size_t el = strlen(exch);
  if (el < 2 || el > 3) return false;
  char last = exch[el - 1];
  if (last < 'A' || last > 'F') return false;
  for (size_t i = 0; i + 1 < el; ++i)
    if (!isdigit(exch[i])) return false;
  int ntx = atoi(exch);                 // stops at the class letter
  if (ntx < 1 || ntx > 32) return false;
  int rem = ntok - 2, ir = 0;
  if (rem == 3 && !strcmp(toks[2], "R")) { ir = 1; rem = 2; }
  if (rem != 2) return false;
  char s6[7];
  if (!normalize_std(toks[0], s6) || !normalize_std(toks[1], s6))
    return false;
  int64_t a = pack_c28(toks[0]), b = pack_c28(toks[1]);
  if (a < 0 || b < 0) return false;
  int n3 = ntx <= 16 ? 3 : 4;
  int intx = ntx <= 16 ? ntx - 1 : ntx - 17;
  set_bits(bits, 0, a, 28);
  set_bits(bits, 28, b, 28);
  bits[56] = ir;
  set_bits(bits, 57, intx, 4);
  set_bits(bits, 61, last - 'A', 3);
  set_bits(bits, 64, s7, 7);
  set_bits(bits, 71, n3, 3);
  set_bits(bits, 74, 0, 3);
  return true;
}

// Nonstandard-call predicate, matching protocol/pack.py:_is_nonstd_call:
// 3-11 chars from the base-38 alphabet with at least one letter, plus a
// digit or '/' (or length >= 4 for letter-only special calls).
bool is_nonstd_call(const char* tok) {
  char s6[7];
  if (normalize_std(tok, s6)) return false;
  if (!strcmp(tok, "CQ") || !strcmp(tok, "DE") || !strcmp(tok, "QRZ"))
    return false;
  size_t n = strlen(tok);
  if ((n > 2) && (!strcmp(tok + n - 2, "/R") || !strcmp(tok + n - 2, "/P"))) {
    char base[16];
    snprintf(base, sizeof base, "%.*s", static_cast<int>(n - 2), tok);
    if (normalize_std(base, s6)) return false;
  }
  if (n < 3 || n > 11) return false;
  bool alpha = false, digslash = false;
  for (const char* p = tok; *p; ++p) {
    if (index_of(kHashAlpha, *p) < 0) return false;
    if (isalpha(*p)) alpha = true;
    if (isdigit(*p) || *p == '/') digslash = true;
  }
  if (!alpha) return false;
  return digslash || n >= 4;
}

// Type 4: h12 c58 h1 r2 c1 — one nonstandard call sent in full
// (protocol/pack.py:_try_pack_nonstd).
bool try_pack_nonstd(char toks[8][16], int ntok, uint8_t* bits) {
  int r2 = 0;
  int n = ntok;
  if (n >= 1) {
    const char* last = toks[n - 1];
    if (!strcmp(last, "RRR")) { r2 = 1; --n; }
    else if (!strcmp(last, "RR73")) { r2 = 2; --n; }
    else if (!strcmp(last, "73")) { r2 = 3; --n; }
  }
  if (n != 2) return false;
  int c1, h1;
  uint64_t h12;
  const char* call;
  char s6[7];
  if (!strcmp(toks[0], "CQ") && is_nonstd_call(toks[1])) {
    c1 = 1; h1 = 0; h12 = 0; call = toks[1];
  } else if (is_nonstd_call(toks[0]) && normalize_std(toks[1], s6)) {
    c1 = 0; h1 = 1; h12 = hash_call(toks[1], 12); call = toks[0];
  } else if (normalize_std(toks[0], s6) && is_nonstd_call(toks[1])) {
    c1 = 0; h1 = 0; h12 = hash_call(toks[0], 12); call = toks[1];
  } else {
    return false;
  }
  uint64_t n58 = 0;
  char padded[12];
  snprintf(padded, sizeof padded, "%11s", call);
  for (int i = 0; i < 11; ++i)
    n58 = n58 * 38 + index_of(kHashAlpha, padded[i]);
  set_bits(bits, 0, h12, 12);
  set_bits(bits, 12, n58, 58);
  bits[70] = h1;
  set_bits(bits, 71, r2, 2);
  bits[73] = c1;
  set_bits(bits, 74, 4, 3);
  return true;
}

}  // namespace

// pack77: message text -> 77 bits; returns 0 on success (standard/free
// text), <0 on hard failure. Mirrors rtlsdr_ft8d_jax/protocol/pack.py.
int ft8_pack77(const char* text_in, uint8_t* bits77) {
  // normalize whitespace + uppercase
  char text[64];
  int n = 0;
  bool space = true;
  for (const char* p = text_in; *p && n < 60; ++p) {
    char c = toupper(*p);
    if (isspace(c)) {
      if (!space && n > 0) { text[n++] = ' '; space = true; }
    } else {
      text[n++] = c;
      space = false;
    }
  }
  while (n > 0 && text[n - 1] == ' ') --n;
  text[n] = 0;

  // tokenize
  char toks[8][16];
  int ntok = 0;
  {
    char tmp[64];
    strcpy(tmp, text);
    char* save = nullptr;
    for (char* t = strtok_r(tmp, " ", &save); t && ntok < 8;
         t = strtok_r(nullptr, " ", &save))
      snprintf(toks[ntok++], 16, "%s", t);
  }

  if (try_pack_dxpedition(toks, ntok, bits77)) return 0;
  if (try_pack_rtty(toks, ntok, bits77)) return 0;
  if (try_pack_fieldday(toks, ntok, bits77)) return 0;
  if (try_pack_nonstd(toks, ntok, bits77)) return 0;

  // try standard type 1/2 — scan ALL tokens for '/P' (it can follow a
  // two-token directed CQ), like the Python packer
  int i3 = 1;
  for (int i = 0; i < ntok; ++i) {
    size_t l = strlen(toks[i]);
    if (l > 2 && !strcmp(toks[i] + l - 2, "/P")) i3 = 2;
  }
  if (ntok >= 2) {
    char fa[20], fb[16], fc[32];
    int ia = 1;
    snprintf(fa, sizeof fa, "%s", toks[0]);
    // consume a directed-CQ modifier even with nothing after it (the
    // std parse then fails for lack of a caller and the message falls
    // to free text, matching the Python packer's merge rule)
    if (!strcmp(toks[0], "CQ") && ntok >= 2) {
      size_t l1 = strlen(toks[1]);
      bool dig = l1 == 3, let = l1 >= 1 && l1 <= 4;
      for (char* p = toks[1]; *p; ++p) {
        dig = dig && isdigit(*p);
        let = let && isalpha(*p);
      }
      if (dig || let) {
        snprintf(fa, sizeof fa, "CQ %s", toks[1]);
        ia = 2;
      }
    }
    if (ia < ntok) {
      snprintf(fb, sizeof fb, "%s", toks[ia]);
      // Bounded accumulation: input text may be up to 60 chars, so the
      // trailing-token join must track remaining capacity (never strcat).
      fc[0] = 0;
      size_t fc_len = 0;
      for (int i = ia + 1; i < ntok; ++i) {
        int wrote = snprintf(fc + fc_len, sizeof fc - fc_len, "%s%s",
                             fc_len ? " " : "", toks[i]);
        if (wrote < 0 || fc_len + wrote >= sizeof fc) {
          fc[sizeof fc - 1] = 0;
          fc_len = sizeof fc - 1;
          break;
        }
        fc_len += wrote;
      }
      auto strip = [&](char* f) {
        size_t l = strlen(f);
        const char* suffix = i3 == 1 ? "/R" : "/P";
        if (l > 2 && !strcmp(f + l - 2, suffix)) { f[l - 2] = 0; return 1; }
        return 0;
      };
      char fa2[20], fb2[16];
      strcpy(fa2, fa);
      strcpy(fb2, fb);
      int ipa = strip(fa2), ipb = strip(fb2);
      int64_t n28a = pack_c28(fa2), n28b = pack_c28(fb2);
      int g15, ir;
      if (n28a >= 0 && n28b >= 0 && pack_g15(fc, &g15, &ir)) {
        int pos = 0;
        set_bits(bits77, pos, n28a, 28); pos += 28;
        bits77[pos++] = ipa;
        set_bits(bits77, pos, n28b, 28); pos += 28;
        bits77[pos++] = ipb;
        bits77[pos++] = ir;
        set_bits(bits77, pos, g15, 15); pos += 15;
        set_bits(bits77, pos, i3, 3);
        return 0;
      }
    }
  }

  // free text fallback (13 chars, base 42)
  {
    char padded[14];
    int len = static_cast<int>(strlen(text));
    if (len > 13) len = 13;
    memset(padded, ' ', 13);
    memcpy(padded + 13 - len, text, len);
    padded[13] = 0;
    // 71-bit big integer via two 64-bit halves: use __int128
    unsigned __int128 v = 0;
    for (int i = 0; i < 13; ++i) {
      int idx = index_of(kFreeText, padded[i]);
      v = v * 42 + (idx < 0 ? 0 : idx);
    }
    for (int i = 0; i < 71; ++i)
      bits77[i] = static_cast<uint8_t>((v >> (70 - i)) & 1);
    set_bits(bits77, 71, 0, 3);
    set_bits(bits77, 74, 0, 3);
    return 0;
  }
}

// unpack77: 77 bits -> text; returns 0 on success, <0 unsupported type.
int ft8_unpack77(const uint8_t* bits77, char* out, size_t cap) {
  int i3 = static_cast<int>(get_bits(bits77, 74, 3));
  if (i3 == 0) {
    int n3 = static_cast<int>(get_bits(bits77, 71, 3));
    if (n3 == 0) {
      unsigned __int128 v = 0;
      for (int i = 0; i < 71; ++i) v = (v << 1) | (bits77[i] & 1);
      char chars[14];
      for (int i = 12; i >= 0; --i) {
        chars[i] = kFreeText[static_cast<int>(v % 42)];
        v /= 42;
      }
      chars[13] = 0;
      char* s = chars;
      while (*s == ' ') ++s;
      char* e = s + strlen(s);
      while (e > s && e[-1] == ' ') *--e = 0;
      snprintf(out, cap, "%s", s);
      return 0;
    }
    if (n3 == 1) {
      // DXpedition: c28 c28 h10 r5 -> "TO RR73; DE <...> +NN"
      uint32_t n28a = static_cast<uint32_t>(get_bits(bits77, 0, 28));
      uint32_t n28b = static_cast<uint32_t>(get_bits(bits77, 28, 56 - 28));
      int r5 = static_cast<int>(get_bits(bits77, 66, 5));
      char ca[20], cb[20];
      if (!unpack_c28(n28a, 0, 1, ca, sizeof ca) ||
          !unpack_c28(n28b, 0, 1, cb, sizeof cb))
        return -1;
      snprintf(out, cap, "%s RR73; %s <...> %+03d", ca, cb, 2 * r5 - 30);
      return 0;
    }
    if (n3 == 3 || n3 == 4) {
      // ARRL Field Day: c28 c28 R1 n4 k3 S7
      uint32_t n28a = static_cast<uint32_t>(get_bits(bits77, 0, 28));
      uint32_t n28b = static_cast<uint32_t>(get_bits(bits77, 28, 28));
      int ir = bits77[56];
      int intx = static_cast<int>(get_bits(bits77, 57, 4));
      int klass = static_cast<int>(get_bits(bits77, 61, 3));
      int s7 = static_cast<int>(get_bits(bits77, 64, 7));
      if (klass > 5 || s7 < 1 || s7 > kNumSections) return -1;
      int ntx = n3 == 3 ? intx + 1 : intx + 17;
      char ca[20], cb[20];
      if (!unpack_c28(n28a, 0, 1, ca, sizeof ca) ||
          !unpack_c28(n28b, 0, 1, cb, sizeof cb))
        return -1;
      snprintf(out, cap, "%s %s %s%d%c %s", ca, cb, ir ? "R " : "", ntx,
               'A' + klass, kArrlSections[s7 - 1]);
      return 0;
    }
    if (n3 == 5) {
      uint64_t hi = get_bits(bits77, 0, 7), lo = get_bits(bits77, 7, 64);
      snprintf(out, cap, "%02llX%016llX",
               static_cast<unsigned long long>(hi),
               static_cast<unsigned long long>(lo));
      return 0;
    }
    // n3 2 (EU VHF) / 6 / 7: typed raw payload, matching unpack.py
    {
      uint64_t hi = get_bits(bits77, 0, 7), lo = get_bits(bits77, 7, 64);
      snprintf(out, cap, "<type0.%d:%02llX%016llX>", n3,
               static_cast<unsigned long long>(hi),
               static_cast<unsigned long long>(lo));
      return 0;
    }
  }
  if (i3 == 3) {
    // RTTY RU: t1 c28 c28 R1 r3 s13 -> "[TU; ]A B [R ]5N9 NNNN"
    int tu = bits77[0];
    uint32_t n28a = static_cast<uint32_t>(get_bits(bits77, 1, 28));
    uint32_t n28b = static_cast<uint32_t>(get_bits(bits77, 29, 28));
    int ir = bits77[57];
    int r3 = static_cast<int>(get_bits(bits77, 58, 3));
    int s13 = static_cast<int>(get_bits(bits77, 61, 13));
    char ca[20], cb[20];
    if (!unpack_c28(n28a, 0, 3, ca, sizeof ca) ||
        !unpack_c28(n28b, 0, 3, cb, sizeof cb))
      return -1;
    snprintf(out, cap, "%s%s %s %s5%d9 %04d", tu ? "TU; " : "", ca, cb,
             ir ? "R " : "", r3 + 2, s13);
    return 0;
  }
  if (i3 == 1 || i3 == 2) {
    uint32_t n28a = static_cast<uint32_t>(get_bits(bits77, 0, 28));
    int ipa = bits77[28];
    uint32_t n28b = static_cast<uint32_t>(get_bits(bits77, 29, 28));
    int ipb = bits77[57];
    int ir = bits77[58];
    int g15 = static_cast<int>(get_bits(bits77, 59, 15));
    char ca[20], cb[20], fc[16];
    if (!unpack_c28(n28a, ipa, i3, ca, sizeof ca) ||
        !unpack_c28(n28b, ipb, i3, cb, sizeof cb))
      return -1;
    unpack_g15(g15, ir, fc, sizeof fc);
    if (fc[0])
      snprintf(out, cap, "%s %s %s", ca, cb, fc);
    else
      snprintf(out, cap, "%s %s", ca, cb);
    return 0;
  }
  if (i3 == 4) {
    uint64_t n58 = get_bits(bits77, 12, 58);
    int h1 = bits77[70];
    int r2 = static_cast<int>(get_bits(bits77, 71, 2));
    int c1 = bits77[73];
    char call[12];
    for (int i = 10; i >= 0; --i) {
      call[i] = kHashAlpha[n58 % 38];
      n58 /= 38;
    }
    call[11] = 0;
    char* s = call;
    while (*s == ' ') ++s;
    char* e4 = s + strlen(s);
    while (e4 > s && e4[-1] == ' ') *--e4 = 0;
    const char* rpt[] = {"", "RRR", "RR73", "73"};
    if (c1)
      snprintf(out, cap, "CQ %s%s%s", s, r2 ? " " : "", rpt[r2]);
    else if (h1 == 0)
      snprintf(out, cap, "<...> %s%s%s", s, r2 ? " " : "", rpt[r2]);
    else
      snprintf(out, cap, "%s <...>%s%s", s, r2 ? " " : "", rpt[r2]);
    return 0;
  }
  // i3 5..7: typed raw payload (74 bits), matching unpack.py
  {
    uint64_t hi = get_bits(bits77, 0, 10), lo = get_bits(bits77, 10, 64);
    snprintf(out, cap, "<type%d:%03llX%016llX>", i3,
             static_cast<unsigned long long>(hi),
             static_cast<unsigned long long>(lo));
    return 0;
  }
}

uint32_t ft8_hash22(const char* call) {
  return static_cast<uint32_t>(hash_call(call, 22));
}

// Batched spot unpack for the host hot path (pipeline host unpack at
// 1000+ channels): each record carries the rendered text, the spot fields
// derived from the payload (protocol/unpack.py:unpack_spot), and the
// exact hash-table side effects the Python unpacker would apply (add_a/
// add_b), so Python only falls back per-record when a hash LOOKUP is
// needed (has_hash: text contains '<').
struct Ft8SpotText {
  char text[64];
  char call[16];
  char loc[8];
  char add_a[16];
  char add_b[16];
  uint8_t is_cq;
  uint8_t has_hash;
  int8_t rc;
  uint8_t pad_;
};

static void spot_fields(const uint8_t* bits, Ft8SpotText* r) {
  int i3 = static_cast<int>(get_bits(bits, 74, 3));
  char ca[20], cb[20];
  ca[0] = cb[0] = 0;  // unpack_c28 may return false without writing
  if (i3 == 1 || i3 == 2) {
    uint32_t n28a = static_cast<uint32_t>(get_bits(bits, 0, 28));
    uint32_t n28b = static_cast<uint32_t>(get_bits(bits, 29, 28));
    int ipb = bits[57];
    int ir = bits[58];
    int g15 = static_cast<int>(get_bits(bits, 59, 15));
    r->is_cq = (n28a >= 2 && n28a <= 532443) ? 1 : 0;
    bool okb = unpack_c28(n28b, ipb, i3, cb, sizeof cb);
    if (okb) {
      if (cb[0] == '<') r->call[0] = 0;
      else snprintf(r->call, sizeof r->call, "%s", cb);
    }
    if (!ir && g15 <= static_cast<int>(kMaxGrid4))
      unpack_g15(g15, 0, r->loc, sizeof r->loc);
    // hash-add side effects (mirrors unpack77's adds, incl. DE/QRZ quirk)
    if (unpack_c28(n28a, bits[28], i3, ca, sizeof ca) && ca[0] != '<' &&
        strncmp(ca, "CQ", 2)) {
      char* sl = strstr(ca, "/R"); if (sl) *sl = 0;
      sl = strstr(ca, "/P"); if (sl) *sl = 0;
      snprintf(r->add_a, sizeof r->add_a, "%s", ca);
    }
    if (okb && cb[0] != '<' && strncmp(cb, "CQ", 2)) {
      char* sl = strstr(cb, "/R"); if (sl) *sl = 0;
      sl = strstr(cb, "/P"); if (sl) *sl = 0;
      snprintf(r->add_b, sizeof r->add_b, "%s", cb);
    }
    return;
  }
  if (i3 == 3) {
    uint32_t n28a = static_cast<uint32_t>(get_bits(bits, 1, 28));
    uint32_t n28b = static_cast<uint32_t>(get_bits(bits, 29, 28));
    r->is_cq = (n28a >= 2 && n28a <= 532443) ? 1 : 0;
    if (unpack_c28(n28b, 0, 3, cb, sizeof cb) && cb[0] != '<')
      snprintf(r->call, sizeof r->call, "%s", cb);
    return;
  }
  if (i3 == 4) {
    uint64_t n58 = get_bits(bits, 12, 58);
    int c1 = bits[73];
    int h1 = bits[70];
    char call[12];
    for (int i = 10; i >= 0; --i) {
      call[i] = kHashAlpha[n58 % 38];
      n58 /= 38;
    }
    call[11] = 0;
    char* s = call;
    while (*s == ' ') ++s;
    char* e = s + strlen(s);
    while (e > s && e[-1] == ' ') *--e = 0;
    // Python _unpack_nonstd always adds the full call to the table
    snprintf(r->add_a, sizeof r->add_a, "%s", s);
    if (c1) {
      r->is_cq = 1;
      snprintf(r->call, sizeof r->call, "%s", s);
    } else if (h1 == 0) {
      // "<OTHER> CALL [rpt]": the c58 call is in the sender slot
      snprintf(r->call, sizeof r->call, "%s", s);
    }
    return;
  }
  // i3 0 / 5-7: text-heuristic CQ fallback (matches unpack_spot)
  if (!strncmp(r->text, "CQ ", 3)) {
    r->is_cq = 1;
    const char* p = r->text + 3;
    const char* sp = strchr(p, ' ');
    size_t n = sp ? static_cast<size_t>(sp - p) : strlen(p);
    if (n >= sizeof r->call) n = sizeof r->call - 1;
    memcpy(r->call, p, n);
    r->call[n] = 0;
  }
}

int ft8_unpack_spot_batch(const uint8_t* packed12, int n,
                          Ft8SpotText* out) {
  int n_ok = 0;
  for (int i = 0; i < n; ++i) {
    Ft8SpotText* r = &out[i];
    memset(r, 0, sizeof *r);
    uint8_t bits[96];
    const uint8_t* p = packed12 + 12 * i;
    for (int b = 0; b < 96; ++b)
      bits[b] = (p[b / 8] >> (7 - (b % 8))) & 1;
    int rc = ft8_unpack77(bits, r->text, sizeof r->text);
    r->rc = static_cast<int8_t>(rc);
    if (rc != 0) continue;
    spot_fields(bits, r);
    r->has_hash = strchr(r->text, '<') ? 1 : 0;
    ++n_ok;
  }
  return n_ok;
}

}  // extern "C"
