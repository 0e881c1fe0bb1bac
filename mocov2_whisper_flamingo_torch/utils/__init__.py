"""Host-side helpers of the port: logging, TensorBoard scalars, WER, tokenizer."""
