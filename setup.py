"""Packaging (reference setup.py:1-198: DS_BUILD_* prebuilt ops, console
scripts, version stamping).

Native ops here are JIT-compiled on first use (ops/op_builder.py); set
DSTPU_BUILD_OPS=1 to precompile them at install time instead.
"""
import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


def _read_version():
    here = os.path.dirname(os.path.abspath(__file__))
    scope = {}
    with open(os.path.join(here, "deepspeed_tpu", "version.py")) as f:
        exec(f.read(), scope)
    return scope["__version__"]


class BuildWithOps(build_py):
    def run(self):
        super().run()
        if os.environ.get("DSTPU_BUILD_OPS") == "1":
            from deepspeed_tpu.ops.op_builder import ALL_OPS

            for name, builder in ALL_OPS.items():
                print(f"prebuilding op: {name}")
                builder().jit_load()


setup(
    name="deepspeed_tpu",
    version=_read_version(),
    description="TPU-native training framework with the DeepSpeed API "
                "(JAX/XLA/Pallas over named-axis device meshes)",
    # deepspeed_tpu_torch: the PyTorch/CUDA port; its CUDA sources ship as
    # package data and are built with nvcc at first use
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch",
                                    "deepspeed_tpu_torch.*"]),
    package_data={"deepspeed_tpu_torch": ["ops/transformer/csrc/*.cu",
                                          "ops/transformer/csrc/*.cuh",
                                          "ops/sparse_attention/csrc/*.cu"]},
    include_package_data=True,
    data_files=[("csrc/adam", ["csrc/adam/cpu_adam.cpp"])],
    install_requires=["jax", "flax", "numpy", "ml_dtypes"],
    python_requires=">=3.10",
    scripts=["bin/ds", "bin/ds_report", "bin/ds_ssh", "bin/ds_elastic"],
    entry_points={
        "console_scripts": [
            "deepspeed=deepspeed_tpu.launcher.runner:main",
            "ds_report=deepspeed_tpu.env_report:cli_main",
        ],
    },
    cmdclass={"build_py": BuildWithOps},
)
