// Reference-model harness: builds the *reference* KModel (headers included
// read-only from /root/reference) from a KMC database and saves it, so tests
// can compare kmcex's model files byte-for-byte.  Also supports dumping a
// database listing as text (mode "list") to validate the Python KMC reader/
// writer.  New code; only calls the reference API.
//
// usage: gen_model list <db_path>
//        gen_model listf <db_path>      (quake mode: float counters)
//        gen_model build <db_path> <save_dir> <ci> <cs> <nh> <nb>
//        gen_model query <save_dir>     (k-mer strings on stdin, occ per line)
#include <cstdio>
#include <cstdlib>
#include <omp.h>
#include <string>
#include <iostream>
#include <vector>
using namespace std;
#include "kmodel.hpp"

int main(int argc, char** argv) {
    if (argc < 3) { fprintf(stderr, "bad args\n"); return 2; }
    string mode = argv[1];
    string db = argv[2];
    if (mode == "list") {
        CKMCFile f;
        if (!f.OpenForListing(db)) { fprintf(stderr, "open failed\n"); return 1; }
        uint32 k = f.KmerLength();
        CKmerAPI kmer(k);
        uint32 count;
        while (f.ReadNextKmer(kmer, count)) {
            printf("%s %u\n", kmer.to_string().c_str(), count);
        }
        return 0;
    }
    if (mode == "listf") {  // quake databases: float counters
        CKMCFile f;
        if (!f.OpenForListing(db)) { fprintf(stderr, "open failed\n"); return 1; }
        uint32 k = f.KmerLength();
        CKmerAPI kmer(k);
        float count;
        while (f.ReadNextKmer(kmer, count)) {
            printf("%s %.9g\n", kmer.to_string().c_str(), count);
        }
        return 0;
    }
    if (mode == "build") {
        if (argc < 8) { fprintf(stderr, "bad args\n"); return 2; }
        string save_dir = argv[3];
        int ci = atoi(argv[4]), cs = atoi(argv[5]);
        int nh = atoi(argv[6]), nb = atoi(argv[7]);
        KModel* km = get_model(ci, cs, nh, nb);
        km->init(db);
        km->save(save_dir);
        return 0;
    }
    if (mode == "query") {
        KModel* km = get_model(db);  // db arg = save_dir here
        string kmer;
        while (cin >> kmer) {
            printf("%d\n", km->kmer_to_occ(kmer));
        }
        return 0;
    }
    if (mode == "qbench") {  // batched query throughput (reference OMP path)
        KModel* km = get_model(db);  // db arg = save_dir here
        int threads = argc > 3 ? atoi(argv[3]) : 4;
        vector<string> qs;
        string kmer;
        while (cin >> kmer) qs.push_back(kmer);
        // warm + timed pass over the reference batch API (kmodel.hpp:90-98)
        vector<int> occs = km->kmer_to_occ(qs, threads);
        double t0 = omp_get_wtime();
        occs = km->kmer_to_occ(qs, threads);
        double dt = omp_get_wtime() - t0;
        long long sum = 0;
        for (int v : occs) sum += v;
        fprintf(stderr, "qbench %zu queries %.4fs (checksum %lld)\n",
                qs.size(), dt, sum);
        printf("%.6f\n", dt);
        return 0;
    }
    fprintf(stderr, "unknown mode\n");
    return 2;
}
