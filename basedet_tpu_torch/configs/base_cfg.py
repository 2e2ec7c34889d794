"""Base config class (the port's own copy of ``basedet_tpu/configs/base_cfg.py``):
a ConfigDict with log-dir linking."""
from __future__ import annotations

import os

from basedet_tpu_torch.utils.config_dict import ConfigDict


class BaseConfig(ConfigDict):
    def link_log_dir(self, link_name: str = "log") -> None:
        """Symlink the output dir next to the working dir."""
        output_dir = self.GLOBAL.OUTPUT_DIR
        os.makedirs(output_dir, exist_ok=True)
        if os.path.islink(link_name):
            os.remove(link_name)
        if not os.path.exists(link_name):
            try:
                os.symlink(os.path.abspath(output_dir), link_name)
            except OSError:
                pass
