"""Model layer: the 5-parameter fin, the NN error surrogate and the
corrected forward model."""
