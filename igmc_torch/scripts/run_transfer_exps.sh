#!/bin/bash
# Zero-shot transfer: evaluate an ML-100K-trained model on Flixster, Douban or
# YahooMusic (--dynamic-dataset: all three --dynamic-* flags; ratings bucketed
# into --num-relations levels, predictions scaled by --multiply-by).
# Usage: igmc_torch/scripts/run_transfer_exps.sh DATANAME [SOURCE_RESULTS_DIR]
#        [extra CLI flags, e.g. --device cpu]
set -e

data=${1:?usage: run_transfer_exps.sh flixster|douban|yahoo_music [src_dir]}
src=${2:-results/ml_100k_mnph200_testmode/}
shift $(( $# < 2 ? $# : 2 ))

num_relations=5
case ${data} in
  yahoo_music) multiply_by=20 ;;
  flixster)    multiply_by=1 ;;
  douban)      multiply_by=1 ;;
  *) echo 'Dataset does not exist.'; exit 1 ;;
esac

python -m igmc_torch.cli.main --data-name "${data}" --epochs 40 --testing \
  --no-train --ensemble --transfer "${src}" --dynamic-dataset \
  --num-relations ${num_relations} --multiply-by ${multiply_by} "$@"
