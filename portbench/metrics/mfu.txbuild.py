"""whole step: a tx build's needed work (portbench/counts_tx.py: its
training sequences at three forward passes, its predicted sequences at
one) at the card's float32 peak, over its wall seconds, in percent."""

from portbench import counts_tx
from portbench.readers import step_mfu


def read(run):
    cfg = dict(run.config["program"]["hparams"],
               n_classes=run.config["data"]["classes"])
    hp = run.config["program"]["hparams"]
    bound = counts_tx.build_bound_s(
        cfg, run.config["data"]["tokens"], hp["train_steps"] * hp["batch"],
        run.config["data"]["test_docs"])
    return step_mfu(run, bound)
