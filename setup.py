#!/usr/bin/env python
"""volumetricinterp_tpu: TPU-native volumetric interpolation of scalar
quantities within a 3D AMISR field of view (JAX/XLA/Pallas)."""

import os
import re

from setuptools import find_packages, setup

here = os.path.abspath(os.path.dirname(__file__))

with open(os.path.join(here, "volumetricinterp_tpu/__init__.py"), encoding="utf-8") as f:
    version = re.findall(r"(?<=__version__..\s)\S+", f.read())[0].strip("'\"")

setup(
    name="volumetricinterp_tpu",
    version=version,
    description=(
        "TPU-native tool for interpolating 3D scalar parameters from AMISR data"
    ),
    long_description=open(os.path.join(here, "README.md"), encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    classifiers=[
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3",
        "Programming Language :: Python :: 3.10",
        "Programming Language :: Python :: 3.11",
        "Programming Language :: Python :: 3.12",
        "Intended Audience :: Science/Research",
        "Topic :: Scientific/Engineering :: Atmospheric Science",
        "Operating System :: OS Independent",
    ],
    packages=find_packages(exclude=["tests", "tests.*"]),
    package_data={"volumetricinterp_tpu": ["example_config.ini"],
                  "volumetricinterp_tpu_torch": ["csrc/*.cu",
                                                 "example_config.ini"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "h5py"],
    extras_require={"plots": ["matplotlib", "cartopy"],
                    # the PyTorch/CUDA port, volumetricinterp_tpu_torch
                    "torch": ["torch"]},
    zip_safe=False,
    entry_points={
        "console_scripts": [
            "volumetricinterp=volumetricinterp_tpu.cli:main",
            "volumetricinterp-validate=volumetricinterp_tpu.cli:validate_main",
            "volumetricinterp-torch=volumetricinterp_tpu_torch.cli:main",
            "volumetricinterp-torch-validate="
            "volumetricinterp_tpu_torch.cli:validate_main",
        ],
    },
)
