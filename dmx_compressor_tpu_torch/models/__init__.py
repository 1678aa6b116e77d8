"""Model zoo of the port: OPT, GPT-2, Llama, Qwen3, Gemma and Mistral."""
