"""Host-side numpy utilities: volume file IO."""
