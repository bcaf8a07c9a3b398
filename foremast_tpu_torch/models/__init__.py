"""Multivariate anomaly scorers: the LSTM autoencoder (``lstm_ae``)."""
