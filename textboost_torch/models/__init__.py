"""Models of the SD family (NCHW nn.Modules with diffusers/transformers
state-dict keys) and the TextBoost text-encoder patch."""
