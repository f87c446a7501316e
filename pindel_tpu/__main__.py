"""CLI entry: ``python -m pindel_tpu -f ref.fa -p reads.txt -o prefix``.

Flag names mirror the reference CLI (fn_parameters.cpp:17-351); only the
subset implemented so far is accepted.
"""
from __future__ import annotations

import argparse
import sys

from pindel_tpu.config import Settings
from pindel_tpu.pipeline import run_files


def _unary(value: str) -> bool:
    """Reference unary-flag value parsing (readParameters,
    fn_parameters.cpp:379-389): an optional following token sets the flag
    false iff its first character is 'f'/'F'/'0', true otherwise."""
    return not (value and (value[0].lower() == "f" or value[0] == "0"))


def _bool_flag(ap, *names, default: bool = False, dest=None, help=None):
    """A reference-style unary flag: bare sets true, an optional value
    token is parsed with ``_unary`` (so ``-r false`` disables a
    default-true flag, matching fn_parameters.cpp semantics)."""
    ap.add_argument(*names, nargs="?", const=True, default=default,
                    type=_unary, dest=dest, help=help, metavar="[T/F]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pindel_tpu",
        description="structural variant discovery on an accelerator "
                    "(pindel-compatible); JAX_PLATFORMS selects the device")
    ap.add_argument("-f", "--fasta", required=True)
    ap.add_argument("-p", "--pindel-file", default=None)
    ap.add_argument("-P", "--pindel-config-file", dest="pindel_config",
                    default=None,
                    help="config file naming one pindel file per line "
                         "(reference readPindelConfigFile, "
                         "pindel.cpp:705-738)")
    ap.add_argument("-i", "--config", default=None,
                    help="bam config: one '<bam> <insert size> <tag>' "
                         "per line")
    ap.add_argument("-o", "--output-prefix", required=True)
    ap.add_argument("-c", "--chromosome", default="ALL")
    ap.add_argument("-j", "--include", default="",
                    help="BED file of regions to include")
    ap.add_argument("-J", "--exclude", default="",
                    help="BED file of regions to exclude")
    ap.add_argument("-x", "--max_range_index", type=int, default=2)
    ap.add_argument("-w", "--window_size", type=float, default=5.0)
    ap.add_argument("-e", "--sequencing_error_rate", type=float, default=0.01)
    ap.add_argument("-E", "--sensitivity", type=float, default=0.95)
    ap.add_argument("-u", "--maximum_allowed_mismatch_rate", type=float,
                    default=0.02)
    ap.add_argument("-m", "--min_perfect_match_around_BP", type=int,
                    default=3)
    ap.add_argument("-a", "--additional_mismatch", type=int, default=1)
    ap.add_argument("-d", "--min_num_matched_bases", type=int, default=30)
    ap.add_argument("-B", "--balance_cutoff", type=int, default=100)
    ap.add_argument("-M", "--minimum_support_for_event", type=int, default=1)
    _bool_flag(ap, "-s", "--report_close_mapped_reads")
    _bool_flag(ap, "-S", "--report_only_close_mapped_reads")
    _bool_flag(ap, "-l", "--report_long_insertions")
    _bool_flag(ap, "-k", "--report_breakpoints")
    ap.add_argument("--force_bp_output", action="store_true",
                    help="resurrect the BP detector the reference disabled")
    _bool_flag(ap, "-r", "--report_inversions", default=True)
    _bool_flag(ap, "-t", "--report_duplications", default=True)
    ap.add_argument("-v", "--min_inversion_size", type=int, default=50)
    ap.add_argument("-b", "--breakdancer", default="",
                    help="BreakDancer calls file to guide far-end search")
    ap.add_argument("-Q", "--output_of_breakdancer_events", default="",
                    help="file for SVs confirmed by BreakDancer calls")
    _bool_flag(ap, "-R", "--RP", dest="search_discordant", default=True,
               help="search for discordant read pairs (BAM input); "
                    "-R false disables")
    _bool_flag(ap, "-I", "--report_interchromosomal_events")
    _bool_flag(ap, "-q", "--detect_DD",
               help="detect dispersed duplications and exit "
                    "(reference pindel.cpp:1744-1746)")
    ap.add_argument("--MAX_DD_BREAKPOINT_DISTANCE", type=int, default=350)
    ap.add_argument("--MAX_DISTANCE_CLUSTER_READS", type=int, default=100)
    ap.add_argument("--MIN_DD_CLUSTER_SIZE", type=int, default=3)
    ap.add_argument("--MIN_DD_BREAKPOINT_SUPPORT", type=int, default=3)
    ap.add_argument("--MIN_DD_MAP_DISTANCE", type=int, default=8000)
    _bool_flag(ap, "--DD_REPORT_DUPLICATION_READS")
    ap.add_argument("-A", "--anchor_quality", type=int, default=0)
    ap.add_argument("-T", "--number_of_threads", type=int, default=1,
                    help="host-side worker threads (reference OpenMP -T)")
    ap.add_argument("-L", "--name_of_logfile", default="",
                    help="redirect the log stream to this file")
    ap.add_argument("-H", "--min_distance_to_the_end", type=int,
                    default=8, dest="min_close",
                    help="minimum number of bases required to match "
                         "reference (close-end)")
    ap.add_argument("-n", "--NM", type=int, default=2, dest="nm",
                    help="minimum edit distance between read and "
                         "reference for realignment (BAM channel)")
    ap.add_argument("--profile", action="store_true",
                    help="print the sub-phase timer registry at exit")
    ap.add_argument("-g", "--genotyping", default=None,
                    help="genotype the SVs listed in this file "
                         "(Type ChrA PosA CI_A ChrB PosB CI_B per record; "
                         "requires -i). The reference ships this path "
                         "disabled (pindel.cpp:1733-1736); here it runs.")
    ap.add_argument("-Y", "--Ploidy", dest="ploidy", default=None,
                    help="per-chromosome ploidy file (ChrName Ploidy)")
    _bool_flag(ap, "-N", "--NormalSamples", dest="normal_samples",
               help="germline read-depth filtering of calls")
    ap.add_argument("-z", "--assembly", default="",
                    help="assembly mode: assemble breakpoints for the SV "
                         "list in this file (Type ChrA PosA CI_A ChrB "
                         "PosB CI_B records) into <prefix>_ASM; the "
                         "reference parses -z then exits "
                         "(pindel.cpp:1738-1742) — here the mode is live")
    _bool_flag(ap, "-C", "--IndelCorrection",
               help="accepted for CLI parity; the reference's only "
                    "use of this flag is commented out "
                    "(pindel.cpp:2006), so it is a no-op there too")
    ap.add_argument("--hosts", type=int, default=1,
                    help="shard windows across N processes (multi-host "
                         "simulation; search scales out, reporting stays "
                         "on rank 0 — see parallel/multihost.py)")
    ap.add_argument("--dist", choices=["files", "jax"], default="files",
                    help="--hosts transport: 'files' spools packed anchor "
                         "tables through a shared directory; 'jax' ships "
                         "them over jax.distributed collectives "
                         "(parallel/distspool.py — the pod data plane)")
    ap.add_argument("--backend", choices=["numpy", "jax", "fused", "mesh"],
                    default="fused")
    args = ap.parse_args(argv)

    s = Settings(
        max_range_index=args.max_range_index,
        window_size_mb=args.window_size,
        seq_error_rate=args.sequencing_error_rate,
        sensitivity=args.sensitivity,
        max_allowed_mismatch_rate=args.maximum_allowed_mismatch_rate,
        min_perfect_match_around_bp=args.min_perfect_match_around_BP,
        additional_mismatch=args.additional_mismatch,
        min_num_matched_bases=args.min_num_matched_bases,
        balance_cutoff=args.balance_cutoff,
        num_reads_to_report_cutoff=args.minimum_support_for_event,
        report_close_mapped_reads=args.report_close_mapped_reads,
        report_only_close_mapped_reads=args.report_only_close_mapped_reads,
        analyze_li=args.report_long_insertions,
        analyze_bp=args.report_breakpoints,
        force_bp_output=args.force_bp_output,
        analyze_inv=args.report_inversions,
        analyze_td=args.report_duplications,
        min_inversion_size=args.min_inversion_size,
        region=args.chromosome,
        include_bed=args.include,
        exclude_bed=args.exclude,
        breakdancer_filename=args.breakdancer,
        breakdancer_output_filename=args.output_of_breakdancer_events,
        search_discordant_read_pair=args.search_discordant,
        report_interchromosomal_events=args.report_interchromosomal_events,
        detect_dd=args.detect_DD,
        max_dd_breakpoint_distance=args.MAX_DD_BREAKPOINT_DISTANCE,
        max_distance_cluster_reads=args.MAX_DISTANCE_CLUSTER_READS,
        min_dd_cluster_size=args.MIN_DD_CLUSTER_SIZE,
        min_dd_breakpoint_support=args.MIN_DD_BREAKPOINT_SUPPORT,
        min_dd_map_distance=args.MIN_DD_MAP_DISTANCE,
        dd_report_duplication_reads=args.DD_REPORT_DUPLICATION_READS,
        min_anchor_quality=args.anchor_quality,
        normal_samples=args.normal_samples,
        num_threads=args.number_of_threads,
        log_filename=args.name_of_logfile,
        min_close=args.min_close,
        nm=args.nm,
        profile=args.profile,
    )
    if args.assembly:
        if not args.config:
            ap.error("-z requires a bam config (-i)")
        from pindel_tpu.assembly import run_assembly_files
        return run_assembly_files(args.fasta, args.config, args.assembly,
                                  args.output_prefix, settings=s,
                                  backend=args.backend)
    if args.genotyping:
        if not args.config:
            ap.error("-g requires a bam config (-i)")
        from pindel_tpu.genotyping import run_genotyping_files
        return run_genotyping_files(args.fasta, args.config,
                                    args.genotyping, args.output_prefix,
                                    ploidy_path=args.ploidy or "")
    if args.detect_DD:
        # -q runs DD detection and exits (reference pindel.cpp:1744-1746)
        from pindel_tpu.dd import run_dd_files
        if not args.config:
            ap.error("-q requires a bam config (-i)")
        return run_dd_files(args.fasta, args.config, args.output_prefix,
                            settings=s, backend=args.backend)
    if args.hosts > 1:
        from pindel_tpu.parallel.multihost import run_files_multihost
        run_files_multihost(args.fasta, args.pindel_file,
                            args.output_prefix, s, args.backend,
                            args.hosts, pindel_config=args.pindel_config,
                            bam_config=args.config, dist=args.dist)
        return 0
    run_files(args.fasta, args.pindel_file, args.output_prefix,
              settings=s, backend=args.backend, bam_config=args.config,
              pindel_config=args.pindel_config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
