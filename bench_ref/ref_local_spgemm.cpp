// Baseline harness: times the REFERENCE CombBLAS local SpGEMM kernel
// (LocalHybridSpGEMM, mtSpGEMM.h:214 — the per-process hot loop of its
// distributed SUMMA) on this host, on the exact matrix an earlier version of our bench
// multiplies.  Compiled against /root/reference headers (read-only) with the
// single-process MPI stub in mpi_stub/.  This is measurement glue, not part
// of the combblas_tpu framework.
//
// Input: binary triples file (int64 m, int64 n, int64 nnz, then nnz *
// (int64 row, int64 col, double val)), produced by bench_ref/make_input.py.
// Output: one line "nnzC=<n> secs=<t>" per timed iteration.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <tuple>
#include <chrono>

#include "CombBLAS/CombBLAS.h"

using namespace combblas;
typedef int64_t IT;
typedef double NT;
typedef PlusTimesSRing<NT, NT> SR;

int main(int argc, char** argv) {
    if (argc < 2) { fprintf(stderr, "usage: %s triples.bin [iters]\n", argv[0]); return 1; }
    int iters = argc > 2 ? atoi(argv[2]) : 3;
    FILE* f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 1; }
    int64_t m, n, nnz;
    if (fread(&m, 8, 1, f) != 1 || fread(&n, 8, 1, f) != 1 || fread(&nnz, 8, 1, f) != 1) return 1;
    std::tuple<IT, IT, NT>* tuples = new std::tuple<IT, IT, NT>[nnz];
    std::vector<int64_t> buf(3);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t rc[2]; double v;
        if (fread(rc, 8, 2, f) != 2 || fread(&v, 8, 1, f) != 1) return 1;
        tuples[i] = std::make_tuple((IT)rc[0], (IT)rc[1], v);
    }
    fclose(f);
    printf("loaded m=%lld n=%lld nnz=%lld\n", (long long)m, (long long)n, (long long)nnz);

    SpTuples<IT, NT> tA(nnz, m, n, tuples);  // takes ownership
    SpDCCols<IT, NT> A(tA, false);
    SpDCCols<IT, NT> B(A);

    // warmup
    {
        SpTuples<IT, NT>* C = LocalHybridSpGEMM<SR, NT>(A, B, false, false);
        printf("warmup nnzC=%lld\n", (long long)C->getnnz());
        delete C;
    }
    for (int it = 0; it < iters; ++it) {
        auto t0 = std::chrono::steady_clock::now();
        SpTuples<IT, NT>* C = LocalHybridSpGEMM<SR, NT>(A, B, false, false);
        auto t1 = std::chrono::steady_clock::now();
        double dt = std::chrono::duration<double>(t1 - t0).count();
        printf("iter=%d nnzC=%lld secs=%.4f\n", it, (long long)C->getnnz(), dt);
        fflush(stdout);
        delete C;
    }
    return 0;
}
