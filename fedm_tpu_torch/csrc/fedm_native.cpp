// fedm_tpu_torch host-side native components (C ABI, loaded with ctypes),
// the port's own copy of the JAX package's native module: the same two
// algorithms line for line, so that both packages give the same RCM
// ordering and the same partition, bit for bit, of the same CSR graph.
//
//  - reverse Cuthill-McKee ordering: node renumbering for gather/scatter
//    locality (bandwidth reduction of the dof adjacency);
//  - greedy graph-growing mesh partitioning: the set-up of the
//    DOF-partitioned domain decomposition (fedm_tpu_torch/parallel/dd.py),
//    the role SCOTCH plays inside DOLFIN's mesh distribution.
//
// Build: fedm_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, first
// use, into fedm_tpu_torch/_build/). Host code: no CUDA here.

#include <cstdint>
#include <queue>
#include <vector>
#include <algorithm>

extern "C" {

// Reverse Cuthill-McKee on a CSR adjacency (symmetric pattern assumed).
// perm[i] = old index of the node placed at new position i.
void rcm_order(int n, const int* rowptr, const int* colidx, int* perm) {
    std::vector<int> degree(n);
    for (int i = 0; i < n; ++i) degree[i] = rowptr[i + 1] - rowptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int> order;
    order.reserve(n);
    std::vector<int> neighbors;

    for (;;) {
        // next start: unvisited node of minimum degree
        int start = -1;
        for (int i = 0; i < n; ++i) {
            if (!visited[i] && (start < 0 || degree[i] < degree[start]))
                start = i;
        }
        if (start < 0) break;
        std::queue<int> q;
        q.push(start);
        visited[start] = 1;
        while (!q.empty()) {
            int u = q.front();
            q.pop();
            order.push_back(u);
            neighbors.clear();
            for (int k = rowptr[u]; k < rowptr[u + 1]; ++k) {
                int v = colidx[k];
                if (v >= 0 && v < n && !visited[v]) {
                    visited[v] = 1;
                    neighbors.push_back(v);
                }
            }
            std::sort(neighbors.begin(), neighbors.end(),
                      [&](int a, int b) { return degree[a] < degree[b]; });
            for (int v : neighbors) q.push(v);
        }
    }
    // reverse
    for (int i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// Greedy graph-growing partition of a CSR graph into n_parts balanced,
// mostly-connected parts. For each part a frontier is grown from an
// unassigned seed; the next cell added is the frontier entry with the
// most already-in-part neighbours (gain), which keeps part boundaries —
// and hence the halo exchanged per Krylov matvec — short. Exact balance:
// part sizes differ by at most one. part[i] in [0, n_parts).
void partition_graph(int n, const int* rowptr, const int* colidx,
                     int n_parts, int* part) {
    std::vector<int> gain(n, 0);
    std::fill(part, part + n, -1);
    int assigned = 0;
    for (int p = 0; p < n_parts; ++p) {
        int quota = (n - assigned) / (n_parts - p);
        if (quota == 0) continue;
        // seed: unassigned node of minimum unassigned-degree (a corner)
        int seed = -1, seed_deg = 1 << 30;
        for (int i = 0; i < n; ++i) {
            if (part[i] >= 0) continue;
            int d = 0;
            for (int k = rowptr[i]; k < rowptr[i + 1]; ++k)
                if (part[colidx[k]] < 0) ++d;
            if (d < seed_deg) { seed = i; seed_deg = d; }
        }
        // grow: max-gain-first priority queue of (gain, node) pairs
        typedef std::pair<int, int> PQE;  // stale entries skipped
        std::priority_queue<PQE> pq;
        pq.push({0, seed});
        int taken = 0;
        while (taken < quota && !pq.empty()) {
            int u = pq.top().second;
            int g = pq.top().first;
            pq.pop();
            if (part[u] >= 0 || g != gain[u]) continue;  // stale
            part[u] = p;
            ++taken;
            ++assigned;
            for (int k = rowptr[u]; k < rowptr[u + 1]; ++k) {
                int v = colidx[k];
                if (v >= 0 && v < n && part[v] < 0) {
                    ++gain[v];
                    pq.push({gain[v], v});
                }
            }
        }
        // disconnected remainder: fill quota from arbitrary unassigned
        for (int i = 0; taken < quota && i < n; ++i) {
            if (part[i] < 0) { part[i] = p; ++taken; ++assigned; }
        }
        for (int i = 0; i < n; ++i) gain[i] = 0;
    }
    // safety: anything left goes to the last part
    for (int i = 0; i < n; ++i)
        if (part[i] < 0) part[i] = n_parts - 1;
}

}  // extern "C"
