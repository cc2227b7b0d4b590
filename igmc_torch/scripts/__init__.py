"""The experiment scripts of the port: `run_fdy.sh` (five seeds on a Monti
dataset), `run_transfer_exps.sh` (zero-shot transfer from an ML-100K
source), `summarize_fdy` (mean and std of the seeds' final RMSEs) and
`transfer_experiment` (the whole ML-100K -> Monti transfer study,
offline). Each runs `python -m igmc_torch.cli.main`."""
