# jax-ft8d — batched JAX FT8 decode framework
# (capability parity with the reference's Dockerfile: a self-contained
# image that runs the daemon; decode runs on whatever jax backend the
# host exposes — CPU works out of the box, NVIDIA GPUs via JAX's CUDA
# plugin.)
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make librtlsdr-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/jax-ft8d
COPY pyproject.toml README.md ./
COPY rtlsdr_ft8d_jax ./rtlsdr_ft8d_jax
COPY native ./native
COPY scripts ./scripts

# jax[cuda12] for NVIDIA GPUs; plain jax runs the same graphs on CPU
RUN pip install --no-cache-dir jax numpy && pip install --no-cache-dir .
RUN make -C native

# self-test at build time: encode -> modulate -> decode loopback
RUN python3 -m rtlsdr_ft8d_jax.host.cli -t

ENTRYPOINT ["python3", "-m", "rtlsdr_ft8d_jax.host.cli"]
CMD ["--help"]
