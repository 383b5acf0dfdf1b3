// Baseline PROVENANCE harness: reconstructs the reference's SpGEMM benchmark
// workload family with the reference's OWN generator and counts its flops
// with the reference's OWN estimator — the committed artifact behind
// bench.py's REF_PRODUCTS_PER_S constant.
//
// The reference's headline SpGEMM logs (ReleaseTests/SCALE2{1,2,3}RMATRMAT/
// btwcent1.*.out) run `MultTime input1_0 input2_0`: A x B of two R-MAT
// matrices of the same scale ("structurally similar" draws — independently
// seeded, identically laid out, so their power-law hubs align).  Its 3D
// SpGEMM driver (3DSpGEMM/mpipspgemm.cpp:150-151) instead multiplies two
// independently SCRAMBLED draws (GenMat(..., scramble=true) twice), whose
// hub alignment is destroyed.  Those two families have wildly different
// flops; this tool measures BOTH, plus A^2, so the bench's baseline constant
// is a measurement, not an assertion:
//
//   1. generate two draws exactly as DistEdgeList::GenGraph500Data does in
//      its deterministic single-rank path (DistEdgeList.cpp:223-280:
//      make_mrg_seed(rank=0, seed2, seed) -> generate_kronecker -> optional
//      RefGen21::scramble), with SSCA initiator (.6, .4/3 x3) and
//      edgefactor 8 — the reference's SpGEMM-benchmark generator settings
//      (3DSpGEMM/mpipspgemm.cpp:135-141);
//   2. assemble SpDCCols via the reference's SpTuples edge-list ctor
//      (SpTuples.cpp:70: value 1.0, duplicates summed, loops kept as
//      GenMat's removeloops=false does);
//   3. count flops with the reference's estimateFLOP (mtSpGEMM.h:1058);
//   4. time the reference's LocalHybridSpGEMM (mtSpGEMM.h:214) on this
//      host for a live same-host wall-time cross-check.
//
// Compiled against /root/reference headers (read-only) with the
// single-process MPI stub in mpi_stub/.  Measurement glue only — never
// imported by the combblas_tpu framework.
//
// Usage: ref_workload <scale> [edgefactor=8] [iters=1] [--no-mult]
//        ref_workload <scale> [edgefactor] --dump <prefix>
//   --dump writes the two unscrambled draws as binary triples files
//   <prefix>_A.bin / <prefix>_B.bin (int64 m, n, nnz, then nnz * (int64 row,
//   int64 col, double val)) so a bench can run the EXACT matrix the
//   reference-workload family defines (same generator, same dedup).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <chrono>

#include "CombBLAS/CombBLAS.h"

using namespace combblas;
typedef int64_t IT;
typedef double NT;
typedef PlusTimesSRing<NT, NT> SR;

// Mirror of DistEdgeList::GenGraph500Data's non-packed single-rank path
// (DistEdgeList.cpp:238-280), deterministic seeds.
static std::vector<int64_t> gen_edges(int scale, int edgefactor,
                                      uint64_t seed2, bool scramble) {
    int64_t n = ((int64_t)1) << scale;
    int64_t nedges = n * (int64_t)edgefactor;
    uint_fast32_t seed[5];
    make_mrg_seed(0 /*rank*/, seed2, seed);
    double initiator[4] = {0.6, 0.4 / 3.0, 0.4 / 3.0, 0.4 / 3.0};  // SSCA
    std::vector<int64_t> edges(2 * nedges, -1);
    generate_kronecker(0, 1, seed, scale, nedges, initiator, edges.data());
    if (scramble) {
        uint64_t val0, val1;
        RefGen21::MakeScrambleValues(val0, val1, seed);
        for (int64_t i = 0; i < nedges; ++i) {
            edges[2 * i + 0] = RefGen21::scramble(edges[2 * i], scale, val0, val1);
            edges[2 * i + 1] = RefGen21::scramble(edges[2 * i + 1], scale, val0, val1);
        }
    }
    return edges;
}

static SpDCCols<IT, NT>* build_mat(std::vector<int64_t>& edges, int scale) {
    int64_t n = ((int64_t)1) << scale;
    int64_t nedges = (int64_t)edges.size() / 2;
    // SpTuples edge-list ctor: value 1, duplicates summed, removeloops=false
    // (GenRmatDist.h:52 passes removeloops=false via SpParMat(*DEL, false))
    std::vector<IT> ev(edges.begin(), edges.end());
    std::vector<int64_t>().swap(edges);
    SpTuples<IT, NT> t(nedges, n, n, ev, false);
    return new SpDCCols<IT, NT>(t, false);
}

static void dump_mat(const SpDCCols<IT, NT>& M, int64_t n, const char* path) {
    SpTuples<IT, NT> t(const_cast<SpDCCols<IT, NT>&>(M));
    FILE* f = fopen(path, "wb");
    if (!f) { perror("open dump"); exit(1); }
    int64_t m = n, nn = n, nnz = t.getnnz();
    fwrite(&m, 8, 1, f); fwrite(&nn, 8, 1, f); fwrite(&nnz, 8, 1, f);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t r = t.rowindex(i), c = t.colindex(i);
        double v = t.numvalue(i);
        fwrite(&r, 8, 1, f); fwrite(&c, 8, 1, f); fwrite(&v, 8, 1, f);
    }
    fclose(f);
    printf("dumped %s: nnz=%lld\n", path, (long long)nnz);
}

static int64_t flops_of(const SpDCCols<IT, NT>& A, const SpDCCols<IT, NT>& B) {
    if (A.isZero() || B.isZero()) return 0;
    IT* colflops = estimateFLOP(A, B);   // mtSpGEMM.h:1058
    int64_t total = 0;
    IT nzc = B.GetDCSC()->nzc;
    for (IT i = 0; i < nzc; ++i) total += colflops[i];
    delete[] colflops;
    return total;
}

static void time_mult(const char* label, const SpDCCols<IT, NT>& A,
                      const SpDCCols<IT, NT>& B, int iters) {
    for (int it = 0; it < iters; ++it) {
        auto t0 = std::chrono::steady_clock::now();
        SpTuples<IT, NT>* C = LocalHybridSpGEMM<SR, NT>(A, B, false, false);
        auto t1 = std::chrono::steady_clock::now();
        double dt = std::chrono::duration<double>(t1 - t0).count();
        printf("%s mult iter=%d nnzC=%lld secs=%.3f\n", label, it,
               (long long)C->getnnz(), dt);
        fflush(stdout);
        delete C;
    }
}

int main(int argc, char** argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s <scale> [edgefactor=8] [iters=1] [--no-mult]\n",
                argv[0]);
        return 1;
    }
    int scale = atoi(argv[1]);
    int ef = argc > 2 ? atoi(argv[2]) : 8;
    if (argc > 4 && strcmp(argv[3], "--dump") == 0) {
        std::vector<int64_t> e1 = gen_edges(scale, ef, 2, false);
        std::vector<int64_t> e2 = gen_edges(scale, ef, 3, false);
        SpDCCols<IT, NT>* A = build_mat(e1, scale);
        SpDCCols<IT, NT>* B = build_mat(e2, scale);
        int64_t n = ((int64_t)1) << scale;
        std::string pre(argv[4]);
        dump_mat(*A, n, (pre + "_A.bin").c_str());
        dump_mat(*B, n, (pre + "_B.bin").c_str());
        return 0;
    }
    int iters = argc > 3 ? atoi(argv[3]) : 1;
    bool do_mult = !(argc > 4 && strcmp(argv[4], "--no-mult") == 0);

    printf("workload: SSCA initiator (.6,.4/3,.4/3,.4/3) ef=%d scale=%d "
           "(3DSpGEMM/mpipspgemm.cpp:135-141)\n", ef, scale);

    // --- family 1: MultTime-style structurally-similar draws (no scramble) ---
    {
        std::vector<int64_t> e1 = gen_edges(scale, ef, 2, false);
        std::vector<int64_t> e2 = gen_edges(scale, ef, 3, false);
        SpDCCols<IT, NT>* A = build_mat(e1, scale);
        SpDCCols<IT, NT>* B = build_mat(e2, scale);
        printf("unscrambled: nnzA=%lld nnzB=%lld\n",
               (long long)A->getnnz(), (long long)B->getnnz());
        printf("flops_AxB_unscrambled=%lld\n", (long long)flops_of(*A, *B));
        printf("flops_A2=%lld\n", (long long)flops_of(*A, *A));
        fflush(stdout);
        if (do_mult) {
            time_mult("AxB_unscrambled", *A, *B, iters);
            time_mult("A2", *A, *A, iters);
        }
        delete A;
        delete B;
    }

    // --- family 2: mpipspgemm-style independently scrambled draws ---
    {
        std::vector<int64_t> e1 = gen_edges(scale, ef, 2, true);
        std::vector<int64_t> e2 = gen_edges(scale, ef, 3, true);
        SpDCCols<IT, NT>* A = build_mat(e1, scale);
        SpDCCols<IT, NT>* B = build_mat(e2, scale);
        printf("scrambled: nnzA=%lld nnzB=%lld\n",
               (long long)A->getnnz(), (long long)B->getnnz());
        printf("flops_AxB_scrambled=%lld\n", (long long)flops_of(*A, *B));
        fflush(stdout);
        if (do_mult) time_mult("AxB_scrambled", *A, *B, iters);
        delete A;
        delete B;
    }
    return 0;
}
