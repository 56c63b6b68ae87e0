// Golden-vector generator: runs the REFERENCE implementation (mounted
// read-only at /root/reference) on deterministic inputs and dumps JSON
// test vectors. The JAX framework's unit tests compare against these files
// bit-exactly — the same oracle pattern the reference uses for its own
// GPU-vs-CPU tests (reference: test/performance/octree.cu:199-203).
//
// Build/run (see Makefile):
//   g++ -std=c++20 -O2 -I/root/reference/include gen_golden.cpp -o gen_golden
//   ./gen_golden > ../golden/reference_golden.json
//
// This file intentionally contains no algorithm logic of its own.

#include <cinttypes>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "cstone/sfc/sfc.hpp"
#include "cstone/tree/csarray.hpp"
#include "cstone/tree/octree.hpp"

using cstone::HilbertKey;
using cstone::MortonKey;

static bool firstItem = true;

static void item()
{
    if (!firstItem) printf(",\n");
    firstItem = false;
}

template<class T>
static void printArr(const char* name, const std::vector<T>& v)
{
    printf("\"%s\": [", name);
    for (size_t i = 0; i < v.size(); ++i)
    {
        if constexpr (sizeof(T) == 8) { printf("%s%" PRIu64, i ? "," : "", (uint64_t)v[i]); }
        else { printf("%s%u", i ? "," : "", (unsigned)v[i]); }
    }
    printf("]");
}

int main()
{
    printf("{\n");

    std::mt19937 gen(42);

    // --- integer coordinate samples, full range ---------------------------
    std::vector<unsigned> ix32, iy32, iz32, ix64, iy64, iz64;
    {
        std::uniform_int_distribution<unsigned> d32(0, 1023), d64(0, (1u << 21) - 1);
        for (int i = 0; i < 512; ++i)
        {
            ix32.push_back(d32(gen));
            iy32.push_back(d32(gen));
            iz32.push_back(d32(gen));
            ix64.push_back(d64(gen));
            iy64.push_back(d64(gen));
            iz64.push_back(d64(gen));
        }
        // corners and edge cases
        unsigned m32 = 1023, m64 = (1u << 21) - 1;
        unsigned cs32[][3] = {{0, 0, 0}, {m32, m32, m32}, {m32, 0, 0}, {0, m32, 0}, {0, 0, m32}, {1, 2, 3}};
        unsigned cs64[][3] = {{0, 0, 0}, {m64, m64, m64}, {m64, 0, 0}, {0, m64, 0}, {0, 0, m64}, {1, 2, 3}};
        for (auto& c : cs32)
        {
            ix32.push_back(c[0]);
            iy32.push_back(c[1]);
            iz32.push_back(c[2]);
        }
        for (auto& c : cs64)
        {
            ix64.push_back(c[0]);
            iy64.push_back(c[1]);
            iz64.push_back(c[2]);
        }
    }

    item();
    printArr("ix32", ix32);
    item();
    printArr("iy32", iy32);
    item();
    printArr("iz32", iz32);
    item();
    printArr("ix64", ix64);
    item();
    printArr("iy64", iy64);
    item();
    printArr("iz64", iz64);

    // --- Morton + Hilbert encodes -----------------------------------------
    {
        std::vector<uint32_t> m32, h32;
        std::vector<uint64_t> m64, h64;
        for (size_t i = 0; i < ix32.size(); ++i)
        {
            m32.push_back(cstone::iMorton<uint32_t>(ix32[i], iy32[i], iz32[i]));
            h32.push_back(cstone::iHilbert<uint32_t>(ix32[i], iy32[i], iz32[i]));
        }
        for (size_t i = 0; i < ix64.size(); ++i)
        {
            m64.push_back(cstone::iMorton<uint64_t>(ix64[i], iy64[i], iz64[i]));
            h64.push_back(cstone::iHilbert<uint64_t>(ix64[i], iy64[i], iz64[i]));
        }
        item();
        printArr("morton32", m32);
        item();
        printArr("hilbert32", h32);
        item();
        printArr("morton64", m64);
        item();
        printArr("hilbert64", h64);
    }

    // --- float -> key encodes (float32 coords, Hilbert) --------------------
    {
        std::uniform_real_distribution<float> df(-1.0f, 1.0f);
        std::vector<float> xs, ys, zs;
        for (int i = 0; i < 256; ++i)
        {
            xs.push_back(df(gen));
            ys.push_back(df(gen));
            zs.push_back(df(gen));
        }
        cstone::Box<float> box(-1.0f, 1.0f);
        std::vector<uint32_t> k32(xs.size());
        std::vector<uint64_t> k64(xs.size());
        for (size_t i = 0; i < xs.size(); ++i)
        {
            k32[i] = cstone::sfc3D<HilbertKey<uint32_t>>(xs[i], ys[i], zs[i], box);
            k64[i] = cstone::sfc3D<HilbertKey<uint64_t>>(xs[i], ys[i], zs[i], box);
        }
        // print coords as bit patterns to avoid decimal round-trip issues
        std::vector<uint32_t> xb, yb, zb;
        for (size_t i = 0; i < xs.size(); ++i)
        {
            uint32_t b;
            memcpy(&b, &xs[i], 4);
            xb.push_back(b);
            memcpy(&b, &ys[i], 4);
            yb.push_back(b);
            memcpy(&b, &zs[i], 4);
            zb.push_back(b);
        }
        item();
        printArr("coords_x_bits", xb);
        item();
        printArr("coords_y_bits", yb);
        item();
        printArr("coords_z_bits", zb);
        item();
        printArr("sfc3d_hilbert32", k32);
        item();
        printArr("sfc3d_hilbert64", k64);
    }

    // --- spanSfcRange examples ---------------------------------------------
    {
        // the documented example (common.hpp:380-390) plus random pairs
        std::vector<uint32_t> spanA, spanB, spanCnt;
        std::vector<uint32_t> spanOut; // concatenated outputs
        std::vector<uint32_t> spanOff; // offsets into spanOut
        auto addSpan = [&](uint32_t a, uint32_t b)
        {
            spanA.push_back(a);
            spanB.push_back(b);
            spanOff.push_back(spanOut.size());
            int n = cstone::spanSfcRange(a, b);
            spanCnt.push_back(n);
            std::vector<uint32_t> out(n);
            cstone::spanSfcRange(a, b, out.data());
            spanOut.insert(spanOut.end(), out.begin(), out.end());
        };
        addSpan(0b001u << 27, 0b0111'0100'0010u << 18); // octal 01 -> 0742
        addSpan(0u, cstone::nodeRange<uint32_t>(0));
        addSpan(0u, 1u);
        std::uniform_int_distribution<uint32_t> dk(0, cstone::nodeRange<uint32_t>(0) - 1);
        for (int i = 0; i < 64; ++i)
        {
            uint32_t a = dk(gen), b = dk(gen);
            if (a == b) continue;
            if (a > b) std::swap(a, b);
            addSpan(a, b);
        }
        spanOff.push_back(spanOut.size());
        item();
        printArr("span_a", spanA);
        item();
        printArr("span_b", spanB);
        item();
        printArr("span_count", spanCnt);
        item();
        printArr("span_offsets", spanOff);
        item();
        printArr("span_out", spanOut);
    }

    // --- cornerstone octree build -------------------------------------------
    {
        // 32-bit: 20k uniform random Hilbert keys, bucket 64
        std::uniform_int_distribution<uint32_t> dk(0, cstone::nodeRange<uint32_t>(0) - 1);
        std::vector<uint32_t> keys(20000);
        for (auto& k : keys)
            k = dk(gen);
        std::sort(keys.begin(), keys.end());
        auto [tree, counts] = cstone::computeOctree(keys.data(), keys.data() + keys.size(), 64u);
        item();
        printArr("octree32_keys_in", keys);
        item();
        printArr("octree32_tree", tree);
        item();
        printArr("octree32_counts", counts);
    }
    {
        // 64-bit: 20k keys, bucket 16
        std::uniform_int_distribution<uint64_t> dk(0, cstone::nodeRange<uint64_t>(0) - 1);
        std::vector<uint64_t> keys(20000);
        for (auto& k : keys)
            k = dk(gen);
        std::sort(keys.begin(), keys.end());
        auto [tree, counts] = cstone::computeOctree(keys.data(), keys.data() + keys.size(), 16u);
        item();
        printArr("octree64_keys_in", keys);
        item();
        printArr("octree64_tree", tree);
        item();
        printArr("octree64_counts", counts);
    }

    // --- fully-linked internal octree (from the 32-bit golden tree) ---------
    {
        std::uniform_int_distribution<uint32_t> dk(0, cstone::nodeRange<uint32_t>(0) - 1);
        std::vector<uint32_t> keys(20000);
        std::mt19937 gen2(7);
        for (auto& k : keys)
            k = dk(gen2);
        std::sort(keys.begin(), keys.end());
        auto [tree, counts] = cstone::computeOctree(keys.data(), keys.data() + keys.size(), 32u);

        cstone::Octree<uint32_t> oct;
        oct.update(tree.data(), cstone::nNodes(tree));
        auto view = oct.data();
        std::vector<uint32_t> prefixes(view.prefixes, view.prefixes + view.numNodes);
        std::vector<uint32_t> childOffsets(view.childOffsets, view.childOffsets + view.numNodes);
        std::vector<uint32_t> parents(view.parents, view.parents + std::max(1, (view.numNodes - 1) / 8));
        std::vector<uint32_t> levelRange(view.levelRange, view.levelRange + cstone::maxTreeLevel<uint32_t>{} + 2);
        std::vector<uint32_t> internalToLeaf;
        for (int i = 0; i < view.numNodes; ++i)
            internalToLeaf.push_back((uint32_t)(int32_t)view.internalToLeaf[i]); // may be negative; stored as 2's complement
        std::vector<uint32_t> leafOrder;
        for (int i = 0; i < view.numLeafNodes; ++i)
            leafOrder.push_back(view.leafToInternal[i + view.numInternalNodes]);

        // upsweep of leaf counts
        std::vector<unsigned> nodeCounts(view.numNodes, 0);
        for (int i = 0; i < view.numLeafNodes; ++i)
            nodeCounts[leafOrder[i]] = counts[i];
        cstone::upsweep({view.levelRange, size_t(cstone::maxTreeLevel<uint32_t>{} + 2)},
                        {view.childOffsets, size_t(view.numNodes)}, nodeCounts.data(),
                        cstone::NodeCount<unsigned>{});

        item();
        printArr("linked32_cstree", tree);
        item();
        printArr("linked32_counts", counts);
        item();
        printArr("linked32_prefixes", prefixes);
        item();
        printArr("linked32_child_offsets", childOffsets);
        item();
        printArr("linked32_parents", parents);
        item();
        printArr("linked32_level_range", levelRange);
        item();
        printArr("linked32_internal_to_leaf", internalToLeaf);
        item();
        printArr("linked32_leaf_order", leafOrder);
        item();
        printArr("linked32_node_counts", nodeCounts);
    }

    // --- spanning tree from boundary keys ------------------------------------
    {
        std::uniform_int_distribution<uint64_t> dk(1, cstone::nodeRange<uint64_t>(0) - 1);
        std::vector<uint64_t> splits = {0};
        for (int i = 0; i < 7; ++i)
            splits.push_back(dk(gen));
        splits.push_back(cstone::nodeRange<uint64_t>(0));
        std::sort(splits.begin(), splits.end());
        auto span = cstone::computeSpanningTree<uint64_t>({splits.data(), splits.size()});
        item();
        printArr("spanning_splits", splits);
        item();
        printArr("spanning_tree", span);
    }

    printf("\n}\n");
    return 0;
}
