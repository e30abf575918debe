"""Seeding, the banded DP and its kernels.

Imports nothing at package level: unlike ``aligngraph2_tpu/ops/__init__``,
which pulls in its device k-mer counter, every module here is imported
where it is used.
"""
