"""BaseModel — the training-wrapper contract (counterpart of
``endosr/models/base.py``).

The reference's model API (``feed_data / optimize_parameters / test /
get_current_log / update_learning_rate / ...``) over torch modules and a
``torch.optim`` optimizer. The LR schedule is a closed-form function of
the update count (``models/lr_schedule.py``), set into the optimizer
before every update, so ``update_learning_rate`` is a query. Checkpoint
save and resume come with ``train.py`` and raise until then.
"""

from __future__ import annotations

from endosr_torch.models.lr_schedule import build_schedule

__all__ = ["BaseModel"]


class BaseModel:
    def __init__(self, opt):
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self.log_dict: dict[str, float] = {}
        self.schedule = None
        self.step = 0                   # optimizer updates made
        if self.is_train and opt.get("train"):
            self.schedule = build_schedule(opt["train"])

    def feed_data(self, data):
        raise NotImplementedError

    def optimize_parameters(self, step=None):
        raise NotImplementedError

    def test(self):
        raise NotImplementedError

    def get_current_log(self):
        return self.log_dict

    def update_learning_rate(self, cur_iter=None):
        """The LR of update ``cur_iter`` (default: the next one); the
        schedule already holds the warmup (``train.warmup_iter``)."""
        return self.get_current_learning_rate(cur_iter)

    def get_current_learning_rate(self, cur_iter=None):
        if self.schedule is None:
            return 0.0
        return self.schedule(self.step if cur_iter is None else cur_iter)

    def save_network(self, *args, **kwargs):
        raise NotImplementedError(
            "save_network: checkpoint saving is not ported yet (it comes "
            "with train.py)")

    def save_training_state(self, *args, **kwargs):
        raise NotImplementedError(
            "save_training_state: checkpoint saving is not ported yet (it "
            "comes with train.py)")

    def resume_training(self, *args, **kwargs):
        raise NotImplementedError(
            "resume_training: resuming from a training state is not ported "
            "yet (it comes with train.py)")
