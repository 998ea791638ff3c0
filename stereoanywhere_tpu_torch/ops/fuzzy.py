"""Fuzzy-logic confidence combinators."""
from __future__ import annotations


def fuzzy_and(x, y):
    return x * y


def fuzzy_or(x, y):
    return x + y - x * y


def fuzzy_not(x):
    return 1.0 - x
