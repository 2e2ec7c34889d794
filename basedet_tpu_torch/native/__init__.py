"""The port's host library (counterpart of ``basedet_tpu/native/``): the
batch pack of the pad collator and the greedy COCO matcher, in C++
(``native_ops.cpp``), compiled at first use by ``build.load``."""
