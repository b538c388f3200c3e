// Benes-network routing for static permutations (offline planner).
//
// A Benes network on n = 2^k elements has 2k-1 exchange stages with
// pair distances  n/2, n/4, ..., 2, 1, 2, ..., n/4, n/2; each stage
// either swaps a pair (i, i^d) or passes it through.  Any permutation
// is routable (Benes 1964); routing = recursive 2-coloring of the
// constraint cycles formed by input-pair and output-pair mates.
//
// route_benes(k, perm, ctrl) computes per-stage control bits such that
// applying the stages IN ORDER to an input array x yields y with
//     y[i] == x[perm[i]]
// ctrl layout: stage-major, ctrl[s*n + i] in {0,1}, replicated to both
// members of each pair (ctrl[s*n + i] == ctrl[s*n + (i^d_s)]).
//
// A copy of gt4py_tpu/native/benes_router.cpp (the PyTorch port imports
// nothing of the JAX package).  It runs on the host, once per static
// permutation; gt4py_tpu_torch/next/benes.py packs its control bits for
// the K9 kernel in csrc/benes.cu.
//
// Build: g++ -O3 -shared -fPIC benes_router.cpp -o libbenes_router.so
// (next/benes.py does this into config.BUILD_DIR at first use).
// Python binding: ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Route one sub-network occupying positions [base, base+m) of the full
// array, realizing out[i] = in[sub_perm[i]] (indices relative to the
// sub-network).  Stage indices: the IN-stage of this level is
// `stage_in`, the OUT-stage is `stage_out` (stage_in < stage_out except
// at the innermost level where they coincide: m == 2 has one stage).
// sub_perm is scratch-owned by the caller; children perms are written
// into child_buf.
void route_level(int64_t m, int64_t base, const int64_t* perm,
                 int64_t n, uint8_t* ctrl, int stage_in, int stage_out,
                 int64_t* upper_perm, int64_t* lower_perm,
                 std::vector<int64_t>& inv_scratch,
                 std::vector<int8_t>& color_scratch) {
  const int64_t h = m / 2;
  uint8_t* cin = ctrl + (int64_t)stage_in * n + base;
  if (m == 2) {
    // single 2-element stage: swap iff perm = (1 0)
    uint8_t s = perm[0] == 1 ? 1 : 0;
    cin[0] = s;
    cin[1] = s;
    return;
  }
  uint8_t* cout = ctrl + (int64_t)stage_out * n + base;

  // perm inverse (relative indices)
  int64_t* inv = inv_scratch.data();
  for (int64_t i = 0; i < m; ++i) inv[perm[i]] = i;

  // 2-color outputs: color[j] = 0 -> x[perm[j]] routes via the upper
  // half.  Constraints: color[j] != color[j ^ h]  (output pair) and
  // color[j] != color[inv[perm[j] ^ h]]  (input pair).
  int8_t* color = color_scratch.data();
  std::memset(color, -1, m);
  for (int64_t seed = 0; seed < m; ++seed) {
    if (color[seed] != -1) continue;
    // walk the alternating cycle starting at seed
    int64_t j = seed;
    int8_t c = 0;
    while (color[j] == -1) {
      color[j] = c;
      int64_t jm = j ^ h;        // output mate: must differ
      color[jm] = (int8_t)(1 - c);
      int64_t jn = inv[perm[jm] ^ h];  // input mate of jm: must differ
      j = jn;
      c = (int8_t)(1 - color[jm]);
    }
  }

  // stage flags + child permutations
  for (int64_t q = 0; q < h; ++q) {
    // E_in: input pair (q, q+h): x[q] enters upper iff its consumer
    // output is colored 0
    uint8_t a = color[inv[q]] == 0 ? 0 : 1;
    cin[q] = a;
    cin[q + h] = a;
  }
  for (int64_t j = 0; j < h; ++j) {
    // E_out: output pair (j, j+h): y[j] comes from lower iff color 1
    uint8_t b = color[j] == 0 ? 0 : 1;
    cout[j] = b;
    cout[j + h] = b;
    // upper sub-network serves output j when color[j]==0, else j+h
    int64_t served_u = (color[j] == 0) ? j : (j + h);
    int64_t served_l = (color[j] == 0) ? (j + h) : j;
    upper_perm[j] = perm[served_u] % h;
    lower_perm[j] = perm[served_l] % h;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.  perm: int64[n] with n = 1<<k; ctrl:
// uint8[(2k-1) * n], caller-allocated.
int route_benes(int32_t k, const int64_t* perm, uint8_t* ctrl) {
  if (k < 1) return 1;
  const int64_t n = (int64_t)1 << k;
  const int n_stages = 2 * k - 1;
  (void)n_stages;

  // iterative recursion over levels: at level l there are 2^l
  // sub-networks of size n >> l, with IN-stage l and OUT-stage
  // (2k-2-l).  Permutations for the current level live in `cur`.
  std::vector<int64_t> cur(perm, perm + n);
  std::vector<int64_t> nxt(n);
  std::vector<int64_t> inv_scratch(n);
  std::vector<int8_t> color_scratch(n);

  for (int l = 0; l <= k - 1; ++l) {
    const int64_t m = n >> l;
    const int stage_in = l;
    const int stage_out = 2 * k - 2 - l;
    for (int64_t b = 0; b < n; b += m) {
      route_level(m, b, cur.data() + b, n, ctrl, stage_in, stage_out,
                  nxt.data() + b, nxt.data() + b + m / 2, inv_scratch,
                  color_scratch);
    }
    if (m == 2) break;  // innermost level routed; children are trivial
    cur.swap(nxt);
  }
  return 0;
}

}  // extern "C"
