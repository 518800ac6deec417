"""Host-side media ingest of the port: probing, frame batches, audio, container
parsing.  The only layer that touches files and decoders."""
