// Golden-vector generator: exercises the *reference* implementation
// (headers included read-only from /root/reference) to produce parity
// fixtures for kmcex's core layer.  Build & run via tests/golden/regen.sh;
// the emitted JSON (golden_core.json) is committed so tests don't need a
// compiler.  This file is new code — it only calls the reference API.
#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>
using namespace std;
#include "tools.hpp"        // Tools::murmur_hash64, codecs, HashSeeds
#include "occu_bin.hpp"     // OccuBin

static string json_escape(const string &s) { return s; }  // [ACGT] only

int main() {
    FILE *f = fopen("golden_core.json", "w");
    fprintf(f, "{\n");

    // --- murmur over assorted byte strings & seeds (tools.hpp:16-50) ---
    vector<string> keys = {
        "A", "AC", "ACG", "ACGT", "ACGTA", "ACGTAC", "ACGTACG", "ACGTACGT",
        "ACGTACGTA", "GATTACagattaca",  // (case: only ACGT expected in model)
        "ACGTACGTACGTACGTACGTACGTACGTACG",   // 31
        "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT",   // 31
        "GCGCGCGCATATATATGCGCGCGCATATATAT",  // 32
        "CCCCCCCCCCCCCCCCCCCCCCCCCCCCC",     // 29 (k31 middle kmer)
    };
    vector<uint32_t> seeds = {HashSeeds[0], HashSeeds[1], HashSeeds[6],
                              HashSeeds[34], HashSeeds[127], 0u, 1u, 4294967295u};
    fprintf(f, "  \"murmur\": [\n");
    bool first = true;
    for (auto &k : keys) {
        for (auto s : seeds) {
            uint64_t h = Tools::murmur_hash64(k.c_str(), (int)k.size(), s);
            fprintf(f, "%s    [\"%s\", %u, \"%llu\"]", first ? "" : ",\n",
                    json_escape(k).c_str(), s, (unsigned long long)h);
            first = false;
        }
    }
    fprintf(f, "\n  ],\n");

    // --- 2-bit codec + revcomp + canonical (tools.hpp:63-167) ---
    vector<pair<string,int>> kmers = {
        {"ACGTACGTACGTACGTACGTACGTACGTACG", 31},
        {"TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT", 31},
        {"AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA", 31},
        {"GATTACAGATTACAGATTACA", 21},
        {"ACGT", 4}, {"A", 1}, {"GC", 2},
        {"CGCGCGCGATATATATCGCGCGCGATATATAT", 32},
        {"TGCATGCATGCATGCATGCATGCAT", 25},
    };
    fprintf(f, "  \"codec\": [\n");
    first = true;
    for (auto &pr : kmers) {
        const string &km = pr.first; int len = pr.second;
        uint64_t u = Tools::kmers2uint64(km);
        uint64_t rc = Tools::get_complementation(u, len);
        string mink = Tools::get_min_kmer(km);
        string back = Tools::uint64_to_string(u, len);
        fprintf(f, "%s    [\"%s\", %d, \"%llu\", \"%llu\", \"%s\", \"%s\"]",
                first ? "" : ",\n", km.c_str(), len,
                (unsigned long long)u, (unsigned long long)rc,
                mink.c_str(), back.c_str());
        first = false;
    }
    fprintf(f, "\n  ],\n");

    // --- bin_to_decimal (tools.hpp:54-61) ---
    fprintf(f, "  \"bin_to_decimal\": [\n");
    {
        uint8_t a1[7] = {1,0,1,1,0,0,1};
        uint8_t a2[7] = {0,0,0,0,0,0,0};
        uint8_t a3[7] = {1,1,1,1,1,1,1};
        uint8_t a4[5] = {0,1,0,1,1};
        fprintf(f, "    [[1,0,1,1,0,0,1], %d],\n", Tools::bin_to_decimal(a1, 7));
        fprintf(f, "    [[0,0,0,0,0,0,0], %d],\n", Tools::bin_to_decimal(a2, 7));
        fprintf(f, "    [[1,1,1,1,1,1,1], %d],\n", Tools::bin_to_decimal(a3, 7));
        fprintf(f, "    [[0,1,0,1,1], %d]\n", Tools::bin_to_decimal(a4, 5));
    }
    fprintf(f, "  ],\n");

    // --- OccuBin tables for several (cs, nh) configs (occu_bin.hpp) ---
    int configs[][2] = {{1023, 7}, {255, 7}, {1023, 6}, {4095, 8}, {65535, 7}};
    fprintf(f, "  \"occu_bin\": [\n");
    for (int c = 0; c < 5; c++) {
        int cs = configs[c][0], nh = configs[c][1];
        OccuBin ob(cs + 1, nh);
        fprintf(f, "%s    {\"cs\": %d, \"nh\": %d, \"occ2bin\": [", c ? ",\n" : "", cs, nh);
        for (int occ = 0; occ <= cs; occ++)
            fprintf(f, "%s%d", occ ? "," : "", ob.occ_to_bin(occ));
        fprintf(f, "], \"bin2mean\": [");
        for (int b = 0; b < (1 << nh); b++)
            fprintf(f, "%s%u", b ? "," : "", ob.bin_to_mean((uint32_t)b));
        fprintf(f, "]}");
    }
    fprintf(f, "\n  ]\n}\n");
    fclose(f);
    printf("wrote golden_core.json\n");
    return 0;
}
