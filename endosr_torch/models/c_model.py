"""CModel, IKC's kernel-code Corrector trainer (counterpart of
``endosr/models/c_model.py``): (SR image, estimated code) → the corrected
code, the pixel criterion against the real code. ``feed_data`` takes a
batch dict ('SR', 'est_ker_map', 'real_ker') or the reference's
positional ``feed_data(sr_img, est_ker_map, ker_map)``."""

from __future__ import annotations

from endosr_torch.models.common import SimpleModel, as_tensor

__all__ = ["CModel"]


class CModel(SimpleModel):
    def _net_inputs(self, batch):
        return (batch["SR"], batch["est_ker_map"])

    def _target(self, batch):
        return batch["real_ker"]

    def feed_data(self, data, est_ker_map=None, ker_map=None):
        if isinstance(data, dict):
            return super().feed_data(data)
        self.batch = {"SR": as_tensor(data),
                      "est_ker_map": as_tensor(est_ker_map)}
        if ker_map is not None:
            self.batch["real_ker"] = as_tensor(ker_map)

    def test(self):
        """The corrected codes → ``self.fake_ker`` (and ``fake_SR``)."""
        b = self._on_device()
        self.fake_ker = self.fake_SR = self._serve(b["SR"], b["est_ker_map"])
        return self.fake_ker

    def get_current_visuals(self):
        out = {"est_ker_map": self.fake_ker}
        if "real_ker" in self.batch:
            out["Batch_ker"] = self.batch["real_ker"]
        return out
