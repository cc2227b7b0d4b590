"""Summarize multi-seed runs: mean +/- std of the final test RMSE per dataset.

    python -m igmc_torch.scripts.summarize_fdy [--results-root results]
        [--prefix _s]

Reads the LAST line of results/<dataset><prefix><seed>_testmode/log.txt
for seeds 1-5 (run_fdy.sh's runs) and takes its final token, the RMSE
(the log format is the JAX package's and the reference's).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def summarize(results_root="results", datasets=("yahoo_music", "douban", "flixster"),
              prefix="_s", seeds=range(1, 6), line_num=-1):
    """{dataset: array of the seeds' RMSEs} for the datasets with at least
    one non-empty log.txt."""
    out = {}
    for dataset in datasets:
        rmses = []
        for seed in seeds:
            log = os.path.join(results_root, f"{dataset}{prefix}{seed}_testmode",
                               "log.txt")
            if not os.path.isfile(log):
                continue
            with open(log) as f:
                lines = f.readlines()
            if not lines:
                continue
            rmses.append(float(lines[line_num].split(" ")[-1]))
        if rmses:
            out[dataset] = np.array(rmses)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--results-root", default="results")
    p.add_argument("--prefix", default="_s")
    args = p.parse_args()
    for dataset, rmse in summarize(args.results_root, prefix=args.prefix).items():
        print(f"Results of {dataset} ({len(rmse)} seeds)")
        print(rmse)
        print("Mean and std of test rmse:")
        print("%.4f$\\pm$%.4f" % (np.mean(rmse).round(4), np.std(rmse).round(4)))


if __name__ == "__main__":
    main()
