"""The plain reference the benchmark judges the program's answers by.

Plain PyTorch over the generated text and queries; it imports nothing
of the program and nothing of JAX."""

from .compare import compare_answers
from .exact_match import LETTERS, MAX_PREFIX, WindowTable

__all__ = ["LETTERS", "MAX_PREFIX", "WindowTable", "compare_answers"]
