"""Container of parallel per-detection tensors (counterpart of
``basedet_tpu/structures/container.py``): a dict whose fields read and write
as attributes, and ``index`` applies one index to every field. The JAX
package registers it as a pytree; PyTorch needs no such registration."""
from __future__ import annotations


class Container(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def index(self, idx) -> "Container":
        """Apply the same index to every field."""
        return Container({k: v[idx] for k, v in self.items()})
