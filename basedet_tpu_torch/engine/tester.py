"""BaseTester: evaluation-loop façade (counterpart of ``basedet_tpu/engine/tester.py``)."""
from __future__ import annotations

from basedet_tpu_torch.utils.logger import logger


class BaseTester:
    def __init__(self, model, dataloader, evaluator):
        self.model = model
        self.dataloader = dataloader
        self.evaluator = evaluator

    def test(self):
        results = self.evaluator.evaluate_model(self.model, self.dataloader)
        logger.info(f"test results: {results}")
        return results
