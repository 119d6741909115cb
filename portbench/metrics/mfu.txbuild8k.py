"""whole step: a hybrid tx build's needed work (portbench/counts_kda.py:
its training sequences at three forward passes, its predicted sequences
at one) at the card's float32 peak, over its wall seconds, in percent."""

from portbench import counts_kda
from portbench.readers import step_mfu


def read(run):
    hp = run.config["program"]["hparams"]
    cfg = dict(hp, n_classes=run.config["data"]["classes"])
    bound = counts_kda.build_bound_s(
        cfg, run.config["data"]["tokens"], hp["train_steps"] * hp["batch"],
        run.config["data"]["test_docs"])
    return step_mfu(run, bound)
