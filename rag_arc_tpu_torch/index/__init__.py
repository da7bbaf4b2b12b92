"""Vector indexes and stores."""
