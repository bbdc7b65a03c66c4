"""I/O: MatrixMarket, TSV/CSV and the binary checkpoint format."""
