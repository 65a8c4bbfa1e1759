"""PModel, IKC's kernel-code Predictor trainer (counterpart of
``endosr/models/p_model.py``): LR image → kernel code, the pixel
criterion against the real code. ``feed_data`` takes a batch dict ('LQ',
'real_ker') or the reference's positional ``feed_data(lr_img, ker_map)``."""

from __future__ import annotations

from endosr_torch.models.common import SimpleModel, as_tensor

__all__ = ["PModel"]


class PModel(SimpleModel):
    def _target(self, batch):
        return batch["real_ker"]

    def feed_data(self, data, ker_map=None):
        if isinstance(data, dict):
            return super().feed_data(data)
        self.batch = {"LQ": as_tensor(data)}
        if ker_map is not None:
            self.batch["real_ker"] = as_tensor(ker_map)

    def test(self):
        """The estimated codes → ``self.fake_ker`` (and ``fake_SR``)."""
        self.fake_ker = self.fake_SR = self._serve(
            self.batch["LQ"].to(self.device))
        return self.fake_ker

    def get_current_visuals(self):
        out = {"est_ker_map": self.fake_ker, "LQ": self.batch["LQ"][0]}
        if "real_ker" in self.batch:
            out["Batch_ker"] = self.batch["real_ker"]
        return out
