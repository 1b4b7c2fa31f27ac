"""GP engine, BQ core, acquisition, marginalization and the BQ facade."""
