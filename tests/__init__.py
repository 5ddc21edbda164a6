"""Test suite, the golden parity corpus and the independent oracle."""
