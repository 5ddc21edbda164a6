#!/bin/sh
# Analyse metagenomics samples with umgap_tpu preset pipelines.
#
# The counterpart of the reference's umgap-analyse.sh
# (/root/reference/scripts/umgap-analyse.sh): where that script wires
# 5-7 processes per sample with pipes, FIFOs, and a Unix-socket index
# service, the umgap_tpu pipelines are fused device programs and the
# index stays resident in device memory across samples. This wrapper delegates straight
# to `umgap-tpu analyse`, which supports the same repeated
# -1/-2/-t/-z/-o multi-sample groups, gzip sniffing, and config-dir
# data-version discovery.
set -e

usage() {
	cat <<USAGE
Usage: $0 [options] -1 <r1[.fq|.fa][.gz]> [-2 <r2.fq[.gz]>] [-z] -o <out.fa> [more samples...]
Options:
  -c dir    config directory (default: XDG unipept discovery)
  -t type   max-sensitivity | high-sensitivity | high-precision (default)
            | max-precision | tryptic-sensitivity | tryptic-precision
  -z        gzip-compress the next output file
Repeat -1/-2/-t/-z/-o for multiple samples; loaded indexes are shared.
USAGE
	exit 1
}

args=""
have_sample=""
while getopts c:t:1:2:o:zh opt; do
	case "$opt" in
	c) args="$args -c $OPTARG" ;;
	t) args="$args -t $OPTARG" ;;
	1) args="$args -1 $OPTARG" ;;
	2) args="$args -2 $OPTARG" ;;
	o) args="$args -o $OPTARG"; have_sample=yes ;;
	z) args="$args -z" ;;
	*) usage ;;
	esac
done
[ -n "$have_sample" ] || usage

exec python -m umgap_tpu analyse $args
