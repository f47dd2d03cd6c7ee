"""Pallas kernel-template library.

The JAX equivalent of the reference's 53 CUCL templates in test/rtc/
(SURVEY.md §2.2): matmul and conv variants, layout transforms,
elementwise/reduction/normalization ops, deterministic test-pattern
generators, stats/quantize instrumentation, and backward ops.
"""
