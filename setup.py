from setuptools import find_packages, setup

setup(
    name="gubernator-tpu",
    version="0.1.0",
    description="TPU-native distributed rate-limiting service",
    packages=find_packages(include=["gubernator_tpu", "gubernator_tpu.*",
                                    "gubernator_tpu_torch",
                                    "gubernator_tpu_torch.*"]),
    package_data={"gubernator_tpu.api": ["proto/*.proto", "proto/*.py"],
                  "gubernator_tpu_torch.api": ["proto/*.proto", "proto/*.py"],
                  "gubernator_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
                  "gubernator_tpu_torch.native": ["host_router.cc"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "grpcio",
        "protobuf",
        "aiohttp",
        "prometheus-client",
    ],
    entry_points={
        "console_scripts": [
            "gubernator-tpu=gubernator_tpu.daemon:main",
            "gubernator-tpu-cluster=gubernator_tpu.cmd.cluster_main:main",
            "gubernator-tpu-cli=gubernator_tpu.cmd.cli:main",
        ],
    },
)
