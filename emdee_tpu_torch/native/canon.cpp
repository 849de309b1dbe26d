// Colored-graph canonical labeling (C++).
//
// The native counterpart of emdee_tpu/modelling/graphs.py::canonical_form —
// the role the nauty C library plays in the reference
// (molecular_graphs.jl:63-82).  McKay-style: equitable refinement
// (1-dim Weisfeiler-Leman with ordered cells) + individualization
// backtracking, canonical form = lexicographically smallest relabeled
// adjacency.  Residue graphs are tiny (≤ ~100 vertices), so clarity over
// asymptotics; the Python implementation is the differential-testing oracle.
//
// C ABI (ctypes, see native/canon.py):
//   int emdee_canonical_form(const uint8_t* adj,  // n*n row-major 0/1
//                            const int32_t* colors,  // color class per vertex
//                            int n,
//                            int32_t* out_order,     // canonical order
//                            uint8_t* out_adj);      // canonical adjacency
// Returns 0 on success.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using Cell = std::vector<int>;
using Partition = std::vector<Cell>;

struct Graph {
    int n;
    std::vector<std::vector<uint8_t>> adj;  // dense 0/1
    std::vector<std::vector<int>> nbrs;
};

// Split every cell by neighbor counts against every cell until stable.
Partition refine(const Graph& g, Partition partition) {
    bool changed = true;
    while (changed) {
        changed = false;
        for (size_t s = 0; s < partition.size() && !changed; ++s) {
            std::vector<uint8_t> in_splitter(g.n, 0);
            for (int v : partition[s]) in_splitter[v] = 1;
            Partition next;
            next.reserve(partition.size());
            for (const Cell& cell : partition) {
                if (cell.size() == 1) {
                    next.push_back(cell);
                    continue;
                }
                // Bucket cell members by neighbor count into the splitter.
                std::vector<std::pair<int, int>> keyed;  // (count, vertex)
                keyed.reserve(cell.size());
                for (int v : cell) {
                    int count = 0;
                    for (int u : g.nbrs[v]) count += in_splitter[u];
                    keyed.emplace_back(count, v);
                }
                std::stable_sort(keyed.begin(), keyed.end(),
                                 [](const auto& a, const auto& b) {
                                     return a.first < b.first;
                                 });
                bool split = keyed.front().first != keyed.back().first;
                if (!split) {
                    next.push_back(cell);
                } else {
                    changed = true;
                    Cell piece;
                    int current = keyed.front().first;
                    for (const auto& [count, v] : keyed) {
                        if (count != current) {
                            next.push_back(piece);
                            piece.clear();
                            current = count;
                        }
                        piece.push_back(v);
                    }
                    next.push_back(piece);
                }
            }
            partition.swap(next);
        }
    }
    return partition;
}

struct Best {
    bool set = false;
    std::vector<uint8_t> key;  // relabeled adjacency bytes
    std::vector<int> order;
};

void relabel_key(const Graph& g, const std::vector<int>& order,
                 std::vector<uint8_t>* out) {
    out->resize(static_cast<size_t>(g.n) * g.n);
    for (int i = 0; i < g.n; ++i)
        for (int j = 0; j < g.n; ++j)
            (*out)[static_cast<size_t>(i) * g.n + j] = g.adj[order[i]][order[j]];
}

void search(const Graph& g, Partition partition, Best* best,
            std::vector<uint8_t>* scratch) {
    partition = refine(g, std::move(partition));
    int target = -1;
    for (size_t i = 0; i < partition.size(); ++i) {
        if (partition[i].size() > 1) {
            target = static_cast<int>(i);
            break;
        }
    }
    if (target < 0) {
        std::vector<int> order;
        order.reserve(g.n);
        for (const Cell& cell : partition) order.push_back(cell[0]);
        relabel_key(g, order, scratch);
        if (!best->set || *scratch < best->key) {
            best->set = true;
            best->key = *scratch;
            best->order = order;
        }
        return;
    }
    const Cell cell = partition[target];
    for (int v : cell) {
        Partition branched;
        branched.reserve(partition.size() + 1);
        for (int i = 0; i < static_cast<int>(partition.size()); ++i) {
            if (i != target) {
                branched.push_back(partition[i]);
                continue;
            }
            branched.push_back({v});
            Cell rest;
            for (int u : cell)
                if (u != v) rest.push_back(u);
            branched.push_back(std::move(rest));
        }
        search(g, std::move(branched), best, scratch);
    }
}

}  // namespace

extern "C" int emdee_canonical_form(const uint8_t* adj, const int32_t* colors,
                                    int n, int32_t* out_order,
                                    uint8_t* out_adj) {
    if (n < 0) return 1;
    if (n == 0) return 0;
    Graph g;
    g.n = n;
    g.adj.assign(n, std::vector<uint8_t>(n, 0));
    g.nbrs.assign(n, {});
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
            if (adj[static_cast<size_t>(i) * n + j]) {
                g.adj[i][j] = 1;
                g.nbrs[i].push_back(j);
            }

    // Initial partition: color classes in ascending class id (callers bin
    // float colors into ordered integer classes).
    int32_t max_class = 0;
    for (int i = 0; i < n; ++i) max_class = std::max(max_class, colors[i]);
    Partition initial;
    for (int32_t cls = 0; cls <= max_class; ++cls) {
        Cell cell;
        for (int v = 0; v < n; ++v)
            if (colors[v] == cls) cell.push_back(v);
        if (!cell.empty()) initial.push_back(std::move(cell));
    }

    Best best;
    std::vector<uint8_t> scratch;
    search(g, std::move(initial), &best, &scratch);
    if (!best.set) return 2;
    for (int i = 0; i < n; ++i) out_order[i] = best.order[i];
    std::memcpy(out_adj, best.key.data(), static_cast<size_t>(n) * n);
    return 0;
}
