from setuptools import find_packages, setup

setup(
    name="basedet_tpu",
    version="0.1.0",
    description="TPU-native object detection framework in JAX/XLA/Pallas",
    packages=find_packages(exclude=("tests",)),
    package_data={"basedet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp", "playground/*/config.py"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    entry_points={
        "console_scripts": [
            # parity with reference setup.py:31-41
            "basedet_train = basedet_tpu.tools.det_train:main",
            "basedet_test = basedet_tpu.tools.det_test:main",
            "basedet_profile = basedet_tpu.tools.profile_net:main",
            "basedet_trace = basedet_tpu.tools.trace_net:main",
            "basedet_dump_cfg = basedet_tpu.tools.dump_cfg:main",
            "basedet_benchmark = basedet_tpu.tools.benchmark:main",
            "basedet_analyze = basedet_tpu.tools.analyze_net:main",
            # the PyTorch/CUDA port's tools
            "basedet_torch_train = basedet_tpu_torch.tools.det_train:main",
            "basedet_torch_test = basedet_tpu_torch.tools.det_test:main",
            "basedet_torch_profile = basedet_tpu_torch.tools.profile_net:main",
            "basedet_torch_trace = basedet_tpu_torch.tools.trace_net:main",
            "basedet_torch_dump_cfg = basedet_tpu_torch.tools.dump_cfg:main",
            "basedet_torch_benchmark = basedet_tpu_torch.tools.benchmark:main",
            "basedet_torch_analyze = basedet_tpu_torch.tools.analyze_net:main",
        ]
    },
)
