"""Build for the native runtime extension: python setup.py build_ext --inplace."""

from setuptools import Extension, setup

setup(
    name="peba1",
    version="0.1.0",
    packages=["peba1"],
    ext_modules=[
        Extension(
            "peba1_native",
            sources=["native/peba1_native.c"],
            extra_compile_args=["-O3"],
        )
    ],
)
