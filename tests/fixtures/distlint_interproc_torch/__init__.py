"""Corpus for the port's distlint rules (tests/test_torch_distlint.py).

Each module exercises one of the port's own rule shapes and marks every
finding it must raise with a trailing ``# expect: Rnnn`` comment; every
other line must stay clean. The reference's self-lint excludes this
directory by its `tests/fixtures/distlint_interproc` substring, and the
port's default lint paths do not reach it.
"""
