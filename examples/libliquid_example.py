"""Package/version information (reference libliquid_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import liquid_dsp_tpu

print(f"liquid_dsp_tpu version {liquid_dsp_tpu.__version__}")
print("Block-streaming SDR DSP framework with the capabilities of "
      "liquid-dsp v1.2.0")
mods = [m for m in dir(liquid_dsp_tpu) if not m.startswith("_")]
print(f"top-level API ({len(mods)} names): {', '.join(sorted(mods)[:12])}, ...")

# native acceleration status (ctypes kernels with numpy fallback)
from liquid_dsp_tpu import native
print(f"native C kernels loaded: {native.lib is not None}")
import jax
print(f"jax backend: {jax.default_backend()}, "
      f"{len(jax.devices())} device(s)")
