"""Sequence file IO."""
