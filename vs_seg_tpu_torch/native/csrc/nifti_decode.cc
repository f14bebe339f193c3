// Native NIFTI(.gz) decoder for the host input pipeline.
//
// The reference's data layer leans on nibabel+torch DataLoader worker
// processes (reference params/VSparams.py:305-335); our loader uses threads,
// so the heavy host-side work (gzip inflate of ~10-60MB volumes, dtype
// conversion + scl scaling) lives here in C++ and runs without the GIL
// (ctypes releases it around the call).
//
// Build: g++ -O3 -shared -fPIC nifti_decode.cc -lz -o libnifti_decode.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

extern "C" {

// Read a whole file, inflating if gzip. Returns malloc'd buffer in *out
// (caller frees via nd_free), length in *out_len. Returns 0 on success.
int nd_read_file(const char* path, uint8_t** out, int64_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  if (fsize < 0) { fclose(f); return -1; }
  fseek(f, 0, SEEK_SET);
  uint8_t* raw = (uint8_t*)malloc(fsize);
  if (!raw) { fclose(f); return -2; }
  if (fread(raw, 1, fsize, f) != (size_t)fsize) { free(raw); fclose(f); return -3; }
  fclose(f);

  if (fsize >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    // gzip: inflate with growing buffer
    size_t cap = (size_t)fsize * 4 + (1 << 20);
    uint8_t* buf = (uint8_t*)malloc(cap);
    if (!buf) { free(raw); return -2; }
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) { free(raw); free(buf); return -4; }
    zs.next_in = raw;
    zs.avail_in = (uInt)fsize;
    size_t total = 0;       // bytes written across ALL members
    size_t member_out = 0;  // zs.total_out counts per inflateReset
    int ret = Z_OK;
    for (;;) {
      if (total == cap) {
        cap *= 2;
        uint8_t* nb = (uint8_t*)realloc(buf, cap);
        if (!nb) { inflateEnd(&zs); free(raw); free(buf); return -2; }
        buf = nb;
      }
      zs.next_out = buf + total;
      zs.avail_out = (uInt)(cap - total);
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs); free(raw); free(buf); return -5;
      }
      total = member_out + zs.total_out;
      if (ret == Z_STREAM_END) {
        // multi-member gzip (e.g. bgzip'd .nii.gz): keep inflating the next
        // member — stopping at the first would silently truncate the volume
        if (zs.avail_in == 0) break;
        member_out = total;
        if (inflateReset(&zs) != Z_OK) {
          inflateEnd(&zs); free(raw); free(buf); return -4;
        }
      }
    }
    inflateEnd(&zs);
    free(raw);
    *out = buf;
    *out_len = (int64_t)total;
    return 0;
  }
  *out = raw;
  *out_len = fsize;
  return 0;
}

void nd_free(uint8_t* buf) { free(buf); }

// Convert raw little-endian voxel payload to float32 with scl scaling.
// datatype codes per NIFTI-1. Returns 0 on success.
int nd_to_float32(const uint8_t* src, int64_t n, int datatype,
                  float slope, float inter, float* dst) {
  if (slope == 0.0f) slope = 1.0f;
#define CONVERT(T)                                            \
  {                                                           \
    const T* s = (const T*)src;                               \
    for (int64_t i = 0; i < n; ++i)                           \
      dst[i] = (float)s[i] * slope + inter;                   \
  }
  switch (datatype) {
    case 2:    CONVERT(uint8_t) break;
    case 4:    CONVERT(int16_t) break;
    case 8:    CONVERT(int32_t) break;
    case 16:   CONVERT(float) break;
    case 64:   CONVERT(double) break;
    case 256:  CONVERT(int8_t) break;
    case 512:  CONVERT(uint16_t) break;
    case 768:  CONVERT(uint32_t) break;
    case 1024: CONVERT(int64_t) break;
    default: return -1;
  }
#undef CONVERT
  return 0;
}

}  // extern "C"
