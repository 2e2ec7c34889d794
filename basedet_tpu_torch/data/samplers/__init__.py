from .samplers import AspectRatioGroupSampler, InferenceSampler, ShuffledBatchSampler

__all__ = ["AspectRatioGroupSampler", "InferenceSampler", "ShuffledBatchSampler"]
