// Measured CPU baseline for bench.py's denominator.
//
// A multithreaded -O3 C++ implementation of the reference's
// high-sensitivity pipeline hot path (translate -a | prot2kmer2lca -o |
// seedextend -g1 -s3 | uniq -d / | taxa2agg -l1 -a hybrid -f0.25;
// scripts/umgap-analyse.sh:283-288) over the exact same workload files
// bench.py consumes (.bench_data/, scripts/gen_bench_workload.py).
//
// This is a deliberately FAST stand-in for the Rust binary (which cannot
// be built here: no Rust toolchain, no egress — see PARITY.md): it
// replaces the FST string-key lookup (src/commands/prot2kmer2lca.rs:174-179)
// with an open-addressing hash probe on packed u64 k-mers, which is
// strictly faster than FST traversal. The measured pairs/s is therefore
// an upper bound on the reference's throughput on the host it runs on,
// making an accelerator-vs-baseline ratio conservative.
//
// Build: make -C native (or g++ -O3 -march=native -std=c++17 -pthread
//        -o baseline_cpu baseline_cpu.cpp)
// Run:   ./baseline_cpu <.bench_data dir> [repeats] [hash|fst]
// Output: one JSON line {"pairs_per_s": ..., "threads": ..., "checksum": ...}
//
// The optional third argument selects the lookup structure:
//   hash (default) — the open-addressing upper bound described above.
//   fst            — a faithful emulation of the structure the reference
//                    actually uses (BurntSushi's fst::Map,
//                    src/commands/prot2kmer2lca.rs:109-114): a minimized
//                    acyclic byte automaton with outputs distributed
//                    along edges (Daciuk/Mihov construction over sorted
//                    keys, outputs pushed by the min-prefix rule exactly
//                    as in the fst crate), looked up by walking 9 byte
//                    transitions with a binary search per node. Per-key
//                    work and memory-access pattern match the Rust
//                    reference's `fst.get` (9 dependent node fetches);
//                    this is the honest "Rust pipeline" denominator,
//                    while `hash` remains the conservative upper bound.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <thread>
#include <vector>

namespace {

constexpr int kReadLen = 100;
constexpr int kK = 9;

// NCBI table 1 in TCAG order; AA code = letter - 'A', '*' = 26.
const char* kTable1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG";
// DNA code (A=0,C=1,G=2,T=3) -> index in TCAG ordering
const int kTcagOf[4] = {2, 1, 3, 0};

std::vector<uint8_t> read_file(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != (size_t)n) { exit(1); }
  fclose(f);
  return buf;
}

// Open-addressing hash table, linear probing, power-of-2 slots.
struct Table {
  std::vector<uint64_t> keys;  // sentinel = ~0ull
  std::vector<int32_t> vals;
  uint64_t mask;

  static uint64_t hash(uint64_t x) {  // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
  }

  void build(const uint64_t* k, const int32_t* v, size_t n) {
    size_t slots = 1;
    while (slots < 2 * n) slots <<= 1;
    keys.assign(slots, ~0ull);
    vals.assign(slots, 0);
    mask = slots - 1;
    for (size_t i = 0; i < n; i++) {
      uint64_t pos = hash(k[i]) & mask;
      while (keys[pos] != ~0ull) pos = (pos + 1) & mask;
      keys[pos] = k[i];
      vals[pos] = v[i];
    }
  }

  inline int32_t get(uint64_t k) const {  // 0 = miss (-o semantics)
    uint64_t pos = hash(k) & mask;
    while (true) {
      uint64_t cur = keys[pos];
      if (cur == k) return vals[pos];
      if (cur == ~0ull) return 0;
      pos = (pos + 1) & mask;
    }
  }
};

// Minimal acyclic byte automaton with outputs — the fst::Map emulation.
// Built from sorted fixed-length (9-byte) keys by the incremental
// sorted-input algorithm: the path of the previous key is minimized
// (hash-consed) up to the common prefix, and outputs are pushed along
// the common prefix with the min-prefix rule, like the fst crate.
struct Fst {
  // Flattened registered states: per node a [first, first+n) slice of
  // the edge arrays, transitions sorted by label for binary search.
  std::vector<uint32_t> node_first;
  std::vector<uint16_t> node_count;
  std::vector<uint8_t> e_label;
  std::vector<uint32_t> e_out;
  std::vector<uint32_t> e_child;
  uint32_t root = 0;

  struct Edge {
    uint8_t label;
    uint32_t out;
    uint32_t child;
  };

  uint32_t register_state(const std::vector<Edge>& edges,
                          std::unordered_map<std::string, uint32_t>* reg) {
    std::string key;
    key.reserve(edges.size() * 9);
    for (const auto& e : edges) {
      key.push_back((char)e.label);
      key.append(reinterpret_cast<const char*>(&e.out), 4);
      key.append(reinterpret_cast<const char*>(&e.child), 4);
    }
    auto it = reg->find(key);
    if (it != reg->end()) return it->second;
    uint32_t id = (uint32_t)node_first.size();
    node_first.push_back((uint32_t)e_label.size());
    node_count.push_back((uint16_t)edges.size());
    for (const auto& e : edges) {
      e_label.push_back(e.label);
      e_out.push_back(e.out);
      e_child.push_back(e.child);
    }
    reg->emplace(std::move(key), id);
    return id;
  }

  void build(const uint64_t* keys_in, const int32_t* vals_in, size_t n) {
    std::vector<std::pair<uint64_t, int32_t>> kv(n);
    for (size_t i = 0; i < n; i++) kv[i] = {keys_in[i], vals_in[i]};
    std::sort(kv.begin(), kv.end());
    std::unordered_map<std::string, uint32_t> reg;
    reg.reserve(n * 2);
    // the single final state (all keys are length 9; no final outputs)
    uint32_t final_id = register_state({}, &reg);
    std::vector<std::vector<Edge>> temp(kK);  // temp[d]: node at depth d
    uint8_t prev[kK] = {0}, cur[kK];
    bool have_prev = false;
    for (size_t i = 0; i < n; i++) {
      for (int d = 0; d < kK; d++)
        cur[d] = (uint8_t)((kv[i].first >> (5 * (kK - 1 - d))) & 31);
      int cp = 0;
      if (have_prev)
        while (cp < kK && cur[cp] == prev[cp]) cp++;
      // freeze the previous key's suffix below the common prefix
      for (int d = kK - 1; d >= cp; d--) {
        uint32_t id = (d == kK - 1)
                          ? final_id
                          : register_state(temp[d + 1], &reg);
        if (d + 1 < kK) temp[d + 1].clear();
        if (d >= 0 && !temp[d].empty()) temp[d].back().child = id;
      }
      // push the new value along the common prefix (min-prefix rule)
      uint32_t rem = (uint32_t)kv[i].second;
      for (int d = 0; d < cp; d++) {
        Edge& e = temp[d].back();
        uint32_t c = std::min(e.out, rem);
        uint32_t delta = e.out - c;
        e.out = c;
        rem -= c;
        if (delta) {
          for (Edge& ch : temp[d + 1]) ch.out += delta;
        }
      }
      // append the new suffix
      for (int d = cp; d < kK; d++)
        temp[d].push_back({cur[d], d == cp ? rem : 0, 0});
      memcpy(prev, cur, kK);
      have_prev = true;
    }
    // freeze the last key's path
    for (int d = kK - 1; d >= 0; d--) {
      uint32_t id = (d == kK - 1) ? final_id : register_state(temp[d + 1], &reg);
      if (d + 1 < kK) temp[d + 1].clear();
      temp[d].back().child = id;
    }
    root = register_state(temp[0], &reg);
    temp[0].clear();
  }

  inline int32_t get(uint64_t k) const {  // 0 = miss (-o semantics)
    uint32_t id = root;
    uint32_t out = 0;
    for (int d = 0; d < kK; d++) {
      uint8_t b = (uint8_t)((k >> (5 * (kK - 1 - d))) & 31);
      uint32_t lo = node_first[id], hi = lo + node_count[id];
      // binary search the sorted transition labels (fst-crate style)
      while (lo < hi) {
        uint32_t mid = (lo + hi) / 2;
        if (e_label[mid] < b)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo >= node_first[id] + node_count[id] || e_label[lo] != b) return 0;
      out += e_out[lo];
      id = e_child[lo];
    }
    return (int32_t)out;
  }

  size_t bytes() const {
    return node_first.size() * 6 + e_label.size() * 9;
  }
};

// seedextend -g1 -s3 (src/commands/seedextend.rs:101-149), in place on
// taxons (with sentinel 0 already appended); appends kept taxa to out.
void seedextend(const std::vector<int32_t>& taxons, int min_seed, int max_gap,
                std::vector<int32_t>* out) {
  size_t start = 0, end = 1;
  int32_t last_tid = taxons[0];
  size_t same_tid = 1, same_max = 1;
  std::vector<std::pair<size_t, size_t>> seeds;
  while (end < taxons.size()) {
    if (last_tid == taxons[end]) { same_tid++; end++; continue; }
    if (last_tid == 0 && same_tid > (size_t)max_gap) {
      if (same_max >= (size_t)min_seed) seeds.emplace_back(start, end - same_tid);
      start = end; last_tid = taxons[end]; same_tid = 1; same_max = 1; end++;
      continue;
    }
    if (last_tid == 0 && (end - start) == same_tid) { end++; start = end; continue; }
    if (last_tid != 0) same_max = std::max(same_max, same_tid);
    last_tid = taxons[end]; same_tid = 1; end++;
  }
  if (same_max >= (size_t)min_seed) {
    if (last_tid == 0) end -= same_tid;
    seeds.emplace_back(start, end);
  }
  for (auto& se : seeds)
    for (size_t i = se.first; i < se.second; i++) out->push_back(taxons[i]);
}

struct Workload {
  std::vector<uint8_t> reads;  // [P][2][100]
  Table table;
  std::vector<int32_t> parent, snap, depth;
  size_t n_pairs;
};

// taxa2agg -l1 -m tree -a hybrid -f 0.25: collapse + subtree sums +
// factor descent, via lineage rows (equivalent realized semantics of
// src/tree/mix.rs:42-64 on counts of valid input taxa).
int32_t tree_mix(const std::vector<std::pair<int32_t, float>>& counts,
                 const Workload& w, float factor) {
  // lineage matrix: per unique taxon, ancestors root..self by depth
  static thread_local std::vector<std::vector<int32_t>> lineages;
  static thread_local std::vector<float> cnt;
  lineages.clear(); cnt.clear();
  int maxd = 0;
  for (auto& tc : counts) {
    std::vector<int32_t> lin;
    int32_t cur = tc.first;
    while (true) {
      lin.push_back(cur);
      if (w.parent[cur] == cur) break;
      cur = w.parent[cur];
    }
    std::reverse(lin.begin(), lin.end());
    maxd = std::max(maxd, (int)lin.size());
    lineages.push_back(std::move(lin));
    cnt.push_back(tc.second);
  }
  float total = 0;
  for (float c : cnt) total += c;
  int32_t x = 1;  // root
  float base = total;
  for (int d = 0; d + 1 < maxd + 1; d++) {
    // children of x at depth d+1 among lineages passing through x at d
    int32_t best_child = -1;
    float best_sum = 0, all = 0;
    // gather distinct branches (small lists; quadratic scan is fine)
    static thread_local std::vector<std::pair<int32_t, float>> branches;
    branches.clear();
    for (size_t i = 0; i < lineages.size(); i++) {
      const auto& lin = lineages[i];
      if ((int)lin.size() <= d + 1 || lin[d] != x) continue;
      int32_t b = lin[d + 1];
      bool found = false;
      for (auto& br : branches)
        if (br.first == b) { br.second += cnt[i]; found = true; break; }
      if (!found) branches.emplace_back(b, cnt[i]);
    }
    if (branches.empty()) break;
    for (auto& br : branches) {
      all += br.second;
      if (best_child < 0 || br.second > best_sum ||
          (br.second == best_sum && br.first < best_child)) {
        best_child = br.first; best_sum = br.second;
      }
    }
    if (branches.size() == 1) { x = best_child; continue; }  // chain collapse
    if (best_sum / base < factor) break;
    x = best_child;
    base = best_sum;
  }
  return x;
}

template <typename Lookup>
uint64_t process_range(const Workload& w, const Lookup& lut, size_t lo,
                       size_t hi) {
  uint64_t checksum = 0;
  std::vector<int32_t> taxons, kept;
  std::vector<uint8_t> rc(kReadLen), aa(kReadLen / 3 + 1);
  std::vector<std::pair<int32_t, float>> counts;
  for (size_t p = lo; p < hi; p++) {
    kept.clear();
    for (int e = 0; e < 2; e++) {
      const uint8_t* codes = &w.reads[(p * 2 + e) * kReadLen];
      for (int i = 0; i < kReadLen; i++) rc[i] = 3 - codes[kReadLen - 1 - i];
      for (int f = 0; f < 6; f++) {
        const uint8_t* s = (f >= 3) ? rc.data() : codes;
        int off = f % 3;
        int naa = (kReadLen - off) / 3;
        for (int i = 0; i < naa; i++) {
          int idx = kTcagOf[s[off + 3 * i]] * 16 + kTcagOf[s[off + 3 * i + 1]] * 4 +
                    kTcagOf[s[off + 3 * i + 2]];
          aa[i] = (uint8_t)(kTable1[idx] == '*' ? 26 : kTable1[idx] - 'A');
        }
        // rolling 9-mer pack + probe (prot2kmer2lca -o)
        taxons.clear();
        if (naa >= kK) {
          uint64_t packed = 0;
          for (int i = 0; i < kK - 1; i++) packed = (packed << 5) | aa[i];
          const uint64_t mask45 = (1ull << 45) - 1;
          for (int i = kK - 1; i < naa; i++) {
            packed = ((packed << 5) | aa[i]) & mask45;
            taxons.push_back(lut.get(packed));
          }
        }
        taxons.push_back(0);  // sentinel (seedextend.rs:99)
        seedextend(taxons, /*min_seed=*/3, /*max_gap=*/1, &kept);
      }
    }
    // uniq merge done by construction (kept spans all 12 frames);
    // agg::count + filter -l1 + tree-mix + snap
    counts.clear();
    for (int32_t t : kept) {
      if (t == 0) continue;
      bool found = false;
      for (auto& c : counts)
        if (c.first == t) { c.second += 1.0f; found = true; break; }
      if (!found) counts.emplace_back(t, 1.0f);
    }
    int32_t result;
    if (counts.empty()) {
      result = 1;
    } else {
      result = w.snap[tree_mix(counts, w, 0.25f)];
    }
    checksum += (uint64_t)result;
  }
  return checksum;
}

}  // namespace

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : ".bench_data";
  int repeats = argc > 2 ? atoi(argv[2]) : 3;
  std::string mode = argc > 3 ? argv[3] : "hash";

  Workload w;
  w.reads = read_file(dir + "/reads.bin");
  w.n_pairs = w.reads.size() / (2 * kReadLen);
  auto kb = read_file(dir + "/index_keys.bin");
  auto vb = read_file(dir + "/index_vals.bin");
  size_t nk = kb.size() / 8;
  Fst fst;
  if (mode == "fst") {
    fst.build(reinterpret_cast<const uint64_t*>(kb.data()),
              reinterpret_cast<const int32_t*>(vb.data()), nk);
    fprintf(stderr, "fst: %zu nodes, %zu edges, %.1f MB\n",
            fst.node_first.size(), fst.e_label.size(),
            fst.bytes() / 1048576.0);
  } else {
    w.table.build(reinterpret_cast<const uint64_t*>(kb.data()),
                  reinterpret_cast<const int32_t*>(vb.data()), nk);
  }
  auto pb = read_file(dir + "/parent.bin");
  auto sb = read_file(dir + "/snap.bin");
  auto db = read_file(dir + "/depth.bin");
  size_t nt = pb.size() / 4;
  w.parent.assign(reinterpret_cast<const int32_t*>(pb.data()),
                  reinterpret_cast<const int32_t*>(pb.data()) + nt);
  w.snap.assign(reinterpret_cast<const int32_t*>(sb.data()),
                reinterpret_cast<const int32_t*>(sb.data()) + nt);
  w.depth.assign(reinterpret_cast<const int32_t*>(db.data()),
                 reinterpret_cast<const int32_t*>(db.data()) + nt);

  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 4;

  double best = 0;
  uint64_t checksum = 0;
  for (int r = 0; r < repeats + 1; r++) {  // first iteration = warmup
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> threads;
    std::vector<uint64_t> sums(nthreads, 0);
    size_t chunk = (w.n_pairs + nthreads - 1) / nthreads;
    for (unsigned t = 0; t < nthreads; t++) {
      size_t lo = t * chunk, hi = std::min(w.n_pairs, lo + chunk);
      threads.emplace_back([&, t, lo, hi] {
        sums[t] = (mode == "fst") ? process_range(w, fst, lo, hi)
                                  : process_range(w, w.table, lo, hi);
      });
    }
    for (auto& th : threads) th.join();
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    checksum = 0;
    for (uint64_t s : sums) checksum += s;
    if (r > 0) best = std::max(best, w.n_pairs / secs);
  }
  printf("{\"pairs_per_s\": %.1f, \"threads\": %u, \"n_pairs\": %zu, "
         "\"mode\": \"%s\", \"checksum\": %llu}\n",
         best, nthreads, w.n_pairs, mode.c_str(),
         (unsigned long long)checksum);
  return 0;
}
