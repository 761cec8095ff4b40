"""Host-side scenario ingestion (CommonRoad XML reader, synthetic scenarios)."""
