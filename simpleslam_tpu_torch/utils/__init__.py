"""Host-side runtime substrate: config, logging, timing, concurrency, IO."""
