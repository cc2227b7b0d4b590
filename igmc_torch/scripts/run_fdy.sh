#!/bin/bash
# Multi-seed harness: run IGMC five times (seeds 1..5) on Flixster, Douban or
# YahooMusic, then summarize with `python -m igmc_torch.scripts.summarize_fdy`.
# Usage: igmc_torch/scripts/run_fdy.sh DATANAME [--device cpu]
set -e

data=${1:?usage: run_fdy.sh flixster|douban|yahoo_music [extra CLI flags]}
shift
for i in $(seq 1 5); do
  python -m igmc_torch.cli.main --data-name "${data}" --save-appendix "_s${i}" \
    --hop 1 --epochs 40 --testing --seed "${i}" --ensemble "$@"
done
