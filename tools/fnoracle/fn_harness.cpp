// Test harness that EXECUTES reference pindel functions on synthetic
// inputs fed via stdin, so the Python re-implementations of the
// genotyping / assembly cores can be pinned by execution instead of by
// reading the C++.  Links against the oracle build's
// object files (tools/build_reference_oracle.sh) with pindel.o's main
// renamed away; nothing from the reference tree is copied.
//
// Modes (argv[1]):
//   gtcore   — genotyping.cpp:184-295: the GetRP4OnDEL numeric core.
//              stdin: nsamples, then "PosA CI_A PosB CI_B", then per
//              sample: nreads + "PosA PosB MQA MQB" lines.  The MQ>=20 /
//              PosA!=PosB filter and short-truncated Distance mirror
//              GetRP4OnDEL:330-360; median/average/STDE/MAD and the
//              Genotype_Based_On_RP line come from the real functions.
//   combine  — assembly.cpp:293-507 CombineReads.
//              stdin: unpadded core sequence, strand, n, then per read:
//              "leftmost up_close_size matched_d matched_rel_pos
//               insert_size tag seq".
//   cleanup  — assembly.cpp:704-717 CleanUpCloseEnd.
//              stdin: "Left Right", n, then per read a line of UP_Close
//              AbsLocs ("k a1 ... ak").
#include <algorithm>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "pindel.h"
#include "assembly.h"
#include "genotyping.h"
#include "user_defined_settings.h"

void createProbTable(const double seqErrorRate, const double sensitivity);

// pure functions defined in genotyping.cpp without header declarations
void getAverageAndSTDE(const std::vector<unsigned>& Distances,
                       unsigned& Average, unsigned& STDE);
void getMAD(const std::vector<unsigned>& Distances, const unsigned& Median,
            unsigned& MAD);
void CountRPSupport4DEL(const std::vector<RPVector>& Reads_RP,
                        const std::vector<std::vector<unsigned> > RP_READ_Index,
                        const Genotyping& OneSV, const unsigned* Median,
                        const unsigned* MAD,
                        std::map<std::string, unsigned>& SampleName2IndexAsMap);

static int run_gtcore() {
  unsigned nsamples;
  Genotyping sv;
  std::cin >> nsamples;
  std::cin >> sv.PosA >> sv.CI_A >> sv.PosB >> sv.CI_B;
  sv.ChrA = sv.ChrB = "chrT";
  std::map<std::string, unsigned> samples;
  std::vector<RPVector> reads_rp(nsamples);
  for (unsigned s = 0; s < nsamples; s++) {
    samples["sample" + std::to_string(s)] = s;
    unsigned nreads;
    std::cin >> nreads;
    for (unsigned i = 0; i < nreads; i++) {
      RP_READ r;
      std::cin >> r.PosA >> r.PosB >> r.MQA >> r.MQB;
      r.ChrNameA = r.ChrNameB = "chrT";
      reads_rp[s].push_back(r);
    }
  }
  // the filter + distance loop of GetRP4OnDEL (genotyping.cpp:330-360),
  // including the short truncation of RP_READ::Distance
  const short Min_MQ = 20;
  std::vector<std::vector<unsigned> > idx(nsamples);
  std::vector<std::vector<unsigned> > dists(nsamples);
  for (unsigned s = 0; s < nsamples; s++) {
    for (unsigned i = 0; i < reads_rp[s].size(); i++) {
      RP_READ& r = reads_rp[s][i];
      if (r.ChrNameA != r.ChrNameB || r.ChrNameA != sv.ChrA) continue;
      if (r.PosA == r.PosB) continue;
      if (r.MQA >= Min_MQ && r.MQB >= Min_MQ) {
        idx[s].push_back(i);
        unsigned d = r.PosA > r.PosB ? r.PosA - r.PosB : r.PosB - r.PosA;
        r.Distance = d;                 // short: truncates, as reference
        dists[s].push_back(d);
      }
    }
  }
  std::vector<unsigned> median(nsamples), average(nsamples),
      stde(nsamples), mad(nsamples);
  for (unsigned s = 0; s < nsamples; s++) {
    if (!dists[s].empty()) {
      std::sort(dists[s].begin(), dists[s].end());
      median[s] = dists[s][dists[s].size() / 2];
      getAverageAndSTDE(dists[s], average[s], stde[s]);
      getMAD(dists[s], median[s], mad[s]);
    }
  }
  std::cout << "===RESULT===\n";
  for (unsigned s = 0; s < nsamples; s++)
    std::cout << "stats " << median[s] << " " << average[s] << " "
              << stde[s] << " " << mad[s] << "\n";
  CountRPSupport4DEL(reads_rp, idx, sv, median.data(), mad.data(), samples);
  return 0;
}

static int run_combine() {
  std::string core, strand_s;
  unsigned n;
  std::cin >> core >> strand_s >> n;
  char strand = strand_s[0];
  // the close-end search emits UniquePoints carrying
  // g_genome.getChr(read.FragName) (searcher.cpp:181) — load the
  // synthetic chromosome through the real Genome::loadAll (which adds
  // the spacer padding) and use its in-memory sequence
  {
    std::ofstream fa("/tmp/fn_harness_chrT.fa");
    fa << ">chrT\n" << core << "\n";
  }
  g_genome.loadAll("/tmp/fn_harness_chrT.fa");
  const std::string& chrseq = g_genome.getChr("chrT")->getSeq();
  std::vector<SPLIT_READ> input;
  std::vector<unsigned> use;
  for (unsigned i = 0; i < n; i++) {
    SPLIT_READ r;
    unsigned upn;
    std::string d, tag, seq;
    std::cin >> r.LeftMostPos >> upn >> d >> r.MatchedRelPos
             >> r.InsertSize >> tag >> seq;
    r.MatchedD = d[0];
    r.Tag = tag;
    r.FragName = "chrT";
    r.setUnmatchedSeq(seq);
    for (unsigned k = 0; k < upn; k++)
      r.UP_Close.push_back(UniquePoint());
    input.push_back(r);
    use.push_back(i);
  }
  std::vector<SPLIT_READ> output;
  CombineReads(chrseq, strand, input, use, output);
  std::cout << "===RESULT===\n" << output.size() << "\n";
  for (const SPLIT_READ& r : output) {
    std::cout << r.getUnmatchedSeq() << "\n"
              << r.Thickness << " " << r.LeftMostPos << " "
              << r.UP_Close.size();
    for (const auto& kv : r.ReadCountPerSample)
      std::cout << " " << kv.first << ":" << kv.second;
    std::cout << "\n";
  }
  return 0;
}

static int run_cleanup() {
  unsigned left, right, n;
  std::cin >> left >> right >> n;
  std::vector<SPLIT_READ> input;
  for (unsigned i = 0; i < n; i++) {
    SPLIT_READ r;
    r.Name = "@r" + std::to_string(i);
    unsigned k;
    std::cin >> k;
    for (unsigned j = 0; j < k; j++) {
      UniquePoint up;
      std::cin >> up.AbsLoc;
      r.UP_Close.push_back(up);
    }
    input.push_back(r);
  }
  CleanUpCloseEnd(input, left, right);
  std::cout << "===RESULT===\n";
  for (const SPLIT_READ& r : input) std::cout << r.Name << "\n";
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::cerr << "usage: fn_harness gtcore|combine|cleanup\n";
    return 2;
  }
  // minimal settings init matching the CLI defaults (fn_parameters.cpp)
  // that GetCloseEnd (called at the tail of CombineReads) consumes.
  // pindel.cpp's bare global `userSettings` is only assigned inside
  // init(), so wire it up here.
  extern UserDefinedSettings* userSettings;
  UserDefinedSettings* us = userSettings = UserDefinedSettings::Instance();
  us->Seq_Error_Rate = 0.01;
  us->sensitivity = 0.95;
  us->MaximumAllowedMismatchRate = 0.02;
  us->ADDITIONAL_MISMATCH = 1;
  us->Min_Perfect_Match_Around_BP = 3;
  createProbTable(0.001 + us->Seq_Error_Rate, us->sensitivity);
  // base-conversion tables are filled inside init() (pindel.cpp:948-976);
  // without them ReverseComplement maps every base to '\0'
  extern char Match[256], Match2N[256], Convert2RC[256], Convert2RC4N[256],
      Cap2LowArray[256];
  Match[(short)'A'] = 'A';
  Match[(short)'C'] = 'C';
  Match[(short)'G'] = 'G';
  Match[(short)'T'] = 'T';
  Match[(short)'N'] = 'X';
  Match[(short)'$'] = '$';
  Match2N[(short)'A'] = 'N';
  Match2N[(short)'C'] = 'N';
  Match2N[(short)'G'] = 'N';
  Match2N[(short)'T'] = 'N';
  Match2N[(short)'N'] = 'X';
  Match2N[(short)'$'] = '$';
  Convert2RC[(short)'A'] = 'T';
  Convert2RC[(short)'C'] = 'G';
  Convert2RC[(short)'G'] = 'C';
  Convert2RC[(short)'T'] = 'A';
  Convert2RC[(short)'N'] = 'X';
  Convert2RC[(short)'$'] = '$';
  Convert2RC4N[(short)'A'] = 'T';
  Convert2RC4N[(short)'C'] = 'G';
  Convert2RC4N[(short)'G'] = 'C';
  Convert2RC4N[(short)'T'] = 'A';
  Convert2RC4N[(short)'N'] = 'N';
  Cap2LowArray[(short)'A'] = 'a';
  Cap2LowArray[(short)'C'] = 'c';
  Cap2LowArray[(short)'G'] = 'g';
  Cap2LowArray[(short)'T'] = 't';
  Cap2LowArray[(short)'N'] = 'n';
  Cap2LowArray[(short)'$'] = 'n';
  std::string mode = argv[1];
  if (mode == "gtcore") return run_gtcore();
  if (mode == "combine") return run_combine();
  if (mode == "cleanup") return run_cleanup();
  std::cerr << "unknown mode " << mode << "\n";
  return 2;
}
