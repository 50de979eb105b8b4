// Native dump toolchain: V0-header parsing, particle-dump reading, and
// multi-rank banded-field joining.
//
// This is the framework's counterpart of the reference's C++ dump-format
// consumers (decks/trecon-reader/vpic-reader.cxx, interfaces/c/*): the
// compute path stays JAX/XLA on the accelerator, while heavy host-side I/O
// post-processing (joining per-rank bricks into a global volume, bulk
// particle reads) runs natively.  Built as both a shared library (ctypes
// bindings in vpic_tpu/io/native.py) and a standalone CLI (vpic_dump).
//
// Byte layouts mirror vpic_tpu/io/dump.py, which mirrors the reference's
// WRITE_HEADER_V0 (src/vpic/dumpmacros.h) and banded dump
// (src/vpic/dump.cxx:1116-1557).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <string>

extern "C" {

struct VpicV0Header {
  int32_t version, dump_type;
  int32_t step, nx, ny, nz;
  float dt, dx, dy, dz;
  float x0, y0, z0;
  float cvac, eps0, damp;
  int32_t rank, nproc;
  int32_t sp_id;
  float q_m;
  // first array header (elem size + up to 4 dims)
  int32_t elem_size, ndim;
  int32_t dims[4];
  int64_t data_offset;  // file offset of the payload after the headers
};

struct VpicBandedHeader {
  VpicV0Header v0;
  int32_t format;       // 0 = band, 1 = band_interleave
  uint64_t mask;
  int32_t stride_x, stride_y, stride_z;
  int32_t nxo, nyo, nzo;
  int64_t data_offset;
};

static int read_v0(FILE* f, VpicV0Header* h) {
  unsigned char probe[5];
  if (fread(probe, 1, 5, f) != 5) return -1;
  if (probe[0] != 8 || probe[1] != 2 || probe[2] != 4 || probe[3] != 4 ||
      probe[4] != 8)
    return -2;
  uint16_t ms;  uint32_t mi;  float mf;  double md;
  if (fread(&ms, 2, 1, f) != 1 || ms != 0xCAFEu) return -3;
  if (fread(&mi, 4, 1, f) != 1 || mi != 0xDEADBEEFu) return -4;
  if (fread(&mf, 4, 1, f) != 1 || mf != 1.0f) return -5;
  if (fread(&md, 8, 1, f) != 1 || md != 1.0) return -6;
  if (fread(&h->version, 4, 2, f) != 2) return -7;
  if (fread(&h->step, 4, 4, f) != 4) return -7;
  if (fread(&h->dt, 4, 4, f) != 4) return -7;
  if (fread(&h->x0, 4, 3, f) != 3) return -7;
  if (fread(&h->cvac, 4, 3, f) != 3) return -7;
  if (fread(&h->rank, 4, 2, f) != 2) return -7;
  if (fread(&h->sp_id, 4, 1, f) != 1) return -7;
  if (fread(&h->q_m, 4, 1, f) != 1) return -7;
  return 0;
}

// Parse a V0 dump with a standard array header (grid/field/hydro/particle).
int vpic_read_v0_header(const char* path, VpicV0Header* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  int rc = read_v0(f, h);
  if (rc == 0) {
    if (fread(&h->elem_size, 4, 2, f) != 2) rc = -8;
    else if (h->ndim < 1 || h->ndim > 4) rc = -9;
    else if (fread(h->dims, 4, h->ndim, f) != (size_t)h->ndim) rc = -8;
    else h->data_offset = ftell(f);
  }
  fclose(f);
  return rc;
}

// Parse a banded dump header (extended header instead of array header).
int vpic_read_banded_header(const char* path, VpicBandedHeader* bh) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  int rc = read_v0(f, &bh->v0);
  if (rc == 0) {
    if (fread(&bh->format, 4, 1, f) != 1 ||
        fread(&bh->mask, 8, 1, f) != 1 ||
        fread(&bh->stride_x, 4, 3, f) != 3 ||
        fread(&bh->nxo, 4, 3, f) != 3)
      rc = -8;
    else
      bh->data_offset = ftell(f);
  }
  fclose(f);
  return rc;
}

// Read all 32-byte particle records from a PARTICLE_DUMP into `out`
// (capacity `cap` records of 8 floats).  Returns the record count or <0.
long vpic_read_particles(const char* path, float* out, long cap) {
  VpicV0Header h;
  int rc = vpic_read_v0_header(path, &h);
  if (rc != 0) return rc;
  if (h.dump_type != 3 || h.elem_size != 32 || h.ndim != 1) return -10;
  long n = h.dims[0];
  if (n > cap) n = cap;
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  fseek(f, h.data_offset, SEEK_SET);
  long got = (long)fread(out, 32, n, f);
  fclose(f);
  return got;
}

static int popcount64(uint64_t m) {
  int c = 0;
  while (m) { c += (int)(m & 1); m >>= 1; }
  return c;
}

// Join per-rank BAND-format banded field/hydro dumps into one global
// brick per variable, written back-to-back as little-endian f32 to
// `out_path` (variable-major, z-major within each variable).  Ranks are
// Cartesian: rank = ix + gpx*(iy + gpy*iz).  Returns the number of
// variables joined, or <0 on error.
int vpic_join_banded(const char** paths, int n, int gpx, int gpy, int gpz,
                     const char* out_path) {
  if (n != gpx * gpy * gpz) return -20;
  VpicBandedHeader h0;
  int rc = vpic_read_banded_header(paths[0], &h0);
  if (rc != 0) return rc;
  if (h0.format != 0) return -21;  // band layout only
  const int nvars = popcount64(h0.mask);
  const long nxo = h0.nxo, nyo = h0.nyo, nzo = h0.nzo;
  const long lsz = nxo * nyo * nzo;
  const long gx = nxo * gpx, gy = nyo * gpy, gz = nzo * gpz;
  std::vector<float> global((size_t)gx * gy * gz);
  std::vector<float> local((size_t)lsz);

  FILE* out = fopen(out_path, "wb");
  if (!out) return -100;

  for (int v = 0; v < nvars; v++) {
    for (int r = 0; r < n; r++) {
      VpicBandedHeader h;
      if (vpic_read_banded_header(paths[r], &h) != 0 ||
          h.nxo != nxo || h.nyo != nyo || h.nzo != nzo ||
          h.mask != h0.mask || h.format != 0) {
        fclose(out);
        return -22;
      }
      FILE* f = fopen(paths[r], "rb");
      if (!f) { fclose(out); return -100; }
      fseek(f, h.data_offset + (long)v * lsz * 4, SEEK_SET);
      if (fread(local.data(), 4, lsz, f) != (size_t)lsz) {
        fclose(f); fclose(out); return -23;
      }
      fclose(f);
      const long ix = r % gpx, iy = (r / gpx) % gpy, iz = r / (gpx * gpy);
      for (long z = 0; z < nzo; z++)
        for (long y = 0; y < nyo; y++) {
          float* dst = global.data() +
              ((iz * nzo + z) * gy + (iy * nyo + y)) * gx + ix * nxo;
          memcpy(dst, local.data() + (z * nyo + y) * nxo, nxo * 4);
        }
    }
    fwrite(global.data(), 4, global.size(), out);
  }
  fclose(out);
  return nvars;
}

}  // extern "C"

#ifdef VPIC_DUMP_MAIN
static const char* kTypes[] = {"grid", "field", "hydro", "particle",
                               "restart"};

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s info <dump>\n"
            "       %s join <gpx> <gpy> <gpz> <out> <dump0> [dump1 ...]\n",
            argv[0], argv[0]);
    return 2;
  }
  if (!strcmp(argv[1], "info")) {
    VpicV0Header h;
    int rc = vpic_read_v0_header(argv[2], &h);
    if (rc != 0) { fprintf(stderr, "parse error %d\n", rc); return 1; }
    printf("type=%s step=%d local=(%d,%d,%d) dt=%g origin=(%g,%g,%g) "
           "rank=%d/%d elem=%dB dims=[",
           h.dump_type >= 0 && h.dump_type < 5 ? kTypes[h.dump_type] : "?",
           h.step, h.nx, h.ny, h.nz, h.dt, h.x0, h.y0, h.z0, h.rank,
           h.nproc, h.elem_size);
    for (int i = 0; i < h.ndim; i++)
      printf("%d%s", h.dims[i], i + 1 < h.ndim ? "," : "");
    printf("]\n");
    return 0;
  }
  if (!strcmp(argv[1], "join") && argc >= 7) {
    int gpx = atoi(argv[2]), gpy = atoi(argv[3]), gpz = atoi(argv[4]);
    std::vector<const char*> paths;
    for (int i = 6; i < argc; i++) paths.push_back(argv[i]);
    int rc = vpic_join_banded(paths.data(), (int)paths.size(), gpx, gpy,
                              gpz, argv[5]);
    if (rc < 0) { fprintf(stderr, "join error %d\n", rc); return 1; }
    printf("joined %d variables -> %s\n", rc, argv[5]);
    return 0;
  }
  fprintf(stderr, "unknown command\n");
  return 2;
}
#endif
