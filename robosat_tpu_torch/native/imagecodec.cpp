// Native image codec for the host side of `predict` and `masks`.
//
// Counterpart of robosat_tpu/native/imagecodec.cpp, limited to what the
// port's tools use: RGB tile decode (PNG hand-rolled over zlib, JPEG via
// libjpeg(-turbo), WebP via libwebp), the index decode of palette PNGs and
// the two palette-PNG encoders (plain, and from the parity-blocked layout
// with the interleave fused into scanline assembly). Called per tile through
// ctypes, which releases the GIL, so the loader and writer thread pools
// scale across host cores.
//
// Every entry point returns 0 on success and a negative code otherwise;
// callers fall back to PIL on any failure (interlaced PNG, 16-bit depth,
// CMYK JPEG, ...), so this path never has to be complete, only fast on the
// formats the pipeline produces (8-bit PNG/JPEG/WebP tiles).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <webp/decode.h>
#include <zlib.h>

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int ERR_IO = -1;        // open/read/write failure
constexpr int ERR_FORMAT = -2;    // not a recognizable image
constexpr int ERR_UNSUPPORTED = -3;  // valid but outside the fast path
constexpr int ERR_CORRUPT = -4;   // parse/inflate failure
constexpr int ERR_DIMS = -5;      // caller buffer dims mismatch

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); return false; }
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// ---------------------------------------------------------------------------
// PNG decode (8-bit, non-interlaced; gray / RGB / palette / +alpha -> RGB)
// ---------------------------------------------------------------------------

const uint8_t kPngSig[8] = {137, 'P', 'N', 'G', '\r', '\n', 26, '\n'};

struct PngHeader {
  uint32_t w = 0, h = 0;
  uint8_t depth = 0, color = 0, interlace = 0;
};

// Walk the chunk list: fill the header, collect IDAT, capture PLTE.
int png_parse(const std::vector<uint8_t>& buf, PngHeader& hdr, std::vector<uint8_t>& idat,
              uint8_t palette[256][3], int* pal_count) {
  if (buf.size() < 8 + 25 || std::memcmp(buf.data(), kPngSig, 8) != 0) return ERR_FORMAT;
  size_t pos = 8;
  *pal_count = 0;
  bool saw_ihdr = false;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const uint8_t* type = &buf[pos + 4];
    if (pos + 12 + size_t(len) > buf.size()) return ERR_CORRUPT;
    const uint8_t* data = &buf[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return ERR_CORRUPT;
      hdr.w = be32(data);
      hdr.h = be32(data + 4);
      hdr.depth = data[8];
      hdr.color = data[9];
      hdr.interlace = data[12];
      saw_ihdr = true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3) return ERR_CORRUPT;
      int n = int(len / 3);
      if (n > 256) return ERR_CORRUPT;
      for (int i = 0; i < n; i++) {
        palette[i][0] = data[3 * i];
        palette[i][1] = data[3 * i + 1];
        palette[i][2] = data[3 * i + 2];
      }
      *pal_count = n;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!saw_ihdr) return ERR_CORRUPT;
  return 0;
}

int png_channels(uint8_t color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 3: return 1;  // palette
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
  }
  return 0;
}

int zlib_inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return ERR_CORRUPT;
  zs.next_in = const_cast<uint8_t*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || zs.avail_out != 0) return ERR_CORRUPT;
  return 0;
}

inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
  int p = int(a) + int(b) - int(c);
  int pa = std::abs(p - int(a)), pb = std::abs(p - int(b)), pc = std::abs(p - int(c));
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// In-place scanline unfilter over the inflated stream (filter byte + row).
int png_unfilter(std::vector<uint8_t>& raw, uint32_t h, size_t stride, int bpp) {
  const std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < h; y++) {
    uint8_t* rowp = &raw[y * (stride + 1)];
    uint8_t filter = rowp[0];
    uint8_t* row = rowp + 1;
    switch (filter) {
      case 0:
        break;
      case 1:
        for (size_t x = bpp; x < stride; x++) row[x] = uint8_t(row[x] + row[x - bpp]);
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) row[x] = uint8_t(row[x] + prev[x]);
        break;
      case 3:
        for (size_t x = 0; x < size_t(bpp); x++) row[x] = uint8_t(row[x] + prev[x] / 2);
        for (size_t x = bpp; x < stride; x++)
          row[x] = uint8_t(row[x] + ((int(row[x - bpp]) + int(prev[x])) >> 1));
        break;
      case 4:
        for (size_t x = 0; x < size_t(bpp); x++) row[x] = uint8_t(row[x] + prev[x]);
        for (size_t x = bpp; x < stride; x++)
          row[x] = uint8_t(row[x] + paeth(row[x - bpp], prev[x], prev[x - bpp]));
        break;
      default:
        return ERR_CORRUPT;
    }
    prev = row;
  }
  return 0;
}

int png_decode_rgb(const std::vector<uint8_t>& buf, uint8_t* out, int out_w, int out_h) {
  PngHeader hdr;
  std::vector<uint8_t> idat;
  uint8_t palette[256][3];
  int pal_count = 0;
  int rc = png_parse(buf, hdr, idat, palette, &pal_count);
  if (rc) return rc;
  if (hdr.depth != 8 || hdr.interlace != 0) return ERR_UNSUPPORTED;
  int ch = png_channels(hdr.color);
  if (!ch) return ERR_UNSUPPORTED;
  if (int(hdr.w) != out_w || int(hdr.h) != out_h) return ERR_DIMS;
  if (hdr.color == 3 && pal_count == 0) return ERR_CORRUPT;

  size_t stride = size_t(hdr.w) * ch;
  std::vector<uint8_t> raw((stride + 1) * hdr.h);
  rc = zlib_inflate_all(idat, raw);
  if (rc) return rc;
  rc = png_unfilter(raw, hdr.h, stride, ch);
  if (rc) return rc;

  for (uint32_t y = 0; y < hdr.h; y++) {
    const uint8_t* row = &raw[y * (stride + 1) + 1];
    uint8_t* dst = out + size_t(y) * hdr.w * 3;
    switch (hdr.color) {
      case 2:
        std::memcpy(dst, row, stride);
        break;
      case 0:
        for (uint32_t x = 0; x < hdr.w; x++) { dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x]; }
        break;
      case 3:
        for (uint32_t x = 0; x < hdr.w; x++) {
          const uint8_t* p = palette[row[x] < pal_count ? row[x] : 0];
          dst[3 * x] = p[0];
          dst[3 * x + 1] = p[1];
          dst[3 * x + 2] = p[2];
        }
        break;
      case 4:
        for (uint32_t x = 0; x < hdr.w; x++) { dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[2 * x]; }
        break;
      case 6:
        for (uint32_t x = 0; x < hdr.w; x++) {
          dst[3 * x] = row[4 * x];
          dst[3 * x + 1] = row[4 * x + 1];
          dst[3 * x + 2] = row[4 * x + 2];
        }
        break;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode via libjpeg(-turbo)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_error_trampoline(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jb, 1);
}

int jpeg_decode_rgb(const std::vector<uint8_t>& buf, uint8_t* out, int out_w, int out_h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_trampoline;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return ERR_CORRUPT;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf.data()), static_cast<unsigned long>(buf.size()));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return ERR_CORRUPT;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (int(cinfo.output_width) != out_w || int(cinfo.output_height) != out_h ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return ERR_DIMS;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * out_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// Format sniffing
// ---------------------------------------------------------------------------

enum Format { FMT_PNG, FMT_JPEG, FMT_WEBP, FMT_UNKNOWN };

Format sniff(const std::vector<uint8_t>& buf) {
  if (buf.size() >= 8 && !std::memcmp(buf.data(), kPngSig, 8)) return FMT_PNG;
  if (buf.size() >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF) return FMT_JPEG;
  if (buf.size() >= 12 && !std::memcmp(buf.data(), "RIFF", 4) && !std::memcmp(buf.data() + 8, "WEBP", 4))
    return FMT_WEBP;
  return FMT_UNKNOWN;
}

// ---------------------------------------------------------------------------
// PNG encode (8-bit palette, filter NONE) — the probability/mask tile writer
// ---------------------------------------------------------------------------

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

void put_chunk(std::vector<uint8_t>& out, const char* type, const uint8_t* data, size_t len) {
  put_be32(out, uint32_t(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = uint32_t(crc32(0, out.data() + start, uInt(len + 4)));
  put_be32(out, crc);
}

int encode_palette_png(const uint8_t* idx, int h, int w, int row_stride, const uint8_t* pal, int npal,
                       int level, std::vector<uint8_t>& out) {
  out.clear();
  out.insert(out.end(), kPngSig, kPngSig + 8);
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(uint32_t(w) >> 24); ihdr[1] = uint8_t(uint32_t(w) >> 16);
  ihdr[2] = uint8_t(uint32_t(w) >> 8);  ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(uint32_t(h) >> 24); ihdr[5] = uint8_t(uint32_t(h) >> 16);
  ihdr[6] = uint8_t(uint32_t(h) >> 8);  ihdr[7] = uint8_t(h);
  ihdr[8] = 8; ihdr[9] = 3; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "PLTE", pal, size_t(npal) * 3);

  // Filtered stream: one 0 (NONE) byte per scanline. Palette tiles are
  // quantized probabilities — the byte-delta filters don't help them, and
  // NONE keeps the deflate input a straight copy.
  std::vector<uint8_t> raw(size_t(h) * (size_t(w) + 1));
  for (int y = 0; y < h; y++) {
    uint8_t* row = &raw[size_t(y) * (w + 1)];
    row[0] = 0;
    std::memcpy(row + 1, idx + size_t(y) * row_stride, size_t(w));
  }
  std::vector<uint8_t> comp(compressBound(uLong(raw.size())));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit(&zs, level) != Z_OK) return ERR_CORRUPT;
  zs.next_in = raw.data();
  zs.avail_in = uInt(raw.size());
  zs.next_out = comp.data();
  zs.avail_out = uInt(comp.size());
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return ERR_CORRUPT;
  put_chunk(out, "IDAT", comp.data(), comp.size() - zs.avail_out);
  put_chunk(out, "IEND", nullptr, 0);
  return 0;
}

int write_file(const char* path, const std::vector<uint8_t>& bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return ERR_IO;
  size_t n = std::fwrite(bytes.data(), 1, bytes.size(), f);
  std::fclose(f);
  return n == bytes.size() ? 0 : ERR_IO;
}

}  // namespace

extern "C" {

// Parse enough of `path` to report dimensions. Returns 0 and fills (w, h),
// or a negative error.
int rs_image_info(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return ERR_IO;
  switch (sniff(buf)) {
    case FMT_PNG: {
      PngHeader hdr;
      std::vector<uint8_t> idat;
      uint8_t palette[256][3];
      int pal_count;
      // Header-only need: IHDR is the first chunk; full walk is still cheap
      // (IDAT bytes are only appended, not inflated).
      int rc = png_parse(buf, hdr, idat, palette, &pal_count);
      if (rc) return rc;
      if (hdr.depth != 8 || hdr.interlace != 0 || !png_channels(hdr.color)) return ERR_UNSUPPORTED;
      *w = int(hdr.w);
      *h = int(hdr.h);
      return 0;
    }
    case FMT_JPEG: {
      jpeg_decompress_struct cinfo;
      JpegErr jerr;
      cinfo.err = jpeg_std_error(&jerr.mgr);
      jerr.mgr.error_exit = jpeg_error_trampoline;
      if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return ERR_CORRUPT;
      }
      jpeg_create_decompress(&cinfo);
      jpeg_mem_src(&cinfo, buf.data(), static_cast<unsigned long>(buf.size()));
      int rc = jpeg_read_header(&cinfo, TRUE);
      if (rc != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return ERR_CORRUPT;
      }
      *w = int(cinfo.image_width);
      *h = int(cinfo.image_height);
      jpeg_destroy_decompress(&cinfo);
      return 0;
    }
    case FMT_WEBP: {
      int ww, hh;
      if (!WebPGetInfo(buf.data(), buf.size(), &ww, &hh)) return ERR_CORRUPT;
      *w = ww;
      *h = hh;
      return 0;
    }
    default:
      return ERR_FORMAT;
  }
}

// Decode `path` as RGB into caller-allocated out (h * w * 3 bytes, row-major).
int rs_decode_rgb(const char* path, uint8_t* out, int w, int h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return ERR_IO;
  switch (sniff(buf)) {
    case FMT_PNG:
      return png_decode_rgb(buf, out, w, h);
    case FMT_JPEG:
      return jpeg_decode_rgb(buf, out, w, h);
    case FMT_WEBP: {
      int ww, hh;
      if (!WebPGetInfo(buf.data(), buf.size(), &ww, &hh)) return ERR_CORRUPT;
      if (ww != w || hh != h) return ERR_DIMS;
      if (!WebPDecodeRGBInto(buf.data(), buf.size(), out, size_t(w) * h * 3, w * 3))
        return ERR_CORRUPT;
      return 0;
    }
    default:
      return ERR_FORMAT;
  }
}

// Decode an 8-bit palette or grayscale PNG as its raw index array (no
// palette applied): `masks` reads the quantized probability indices.
int rs_decode_indices(const char* path, uint8_t* out, int w, int h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return ERR_IO;
  if (sniff(buf) != FMT_PNG) return ERR_UNSUPPORTED;
  PngHeader hdr;
  std::vector<uint8_t> idat;
  uint8_t palette[256][3];
  int pal_count = 0;
  int rc = png_parse(buf, hdr, idat, palette, &pal_count);
  if (rc) return rc;
  if (hdr.depth != 8 || hdr.interlace != 0) return ERR_UNSUPPORTED;
  if (hdr.color != 3 && hdr.color != 0) return ERR_UNSUPPORTED;  // palette or gray
  if (int(hdr.w) != w || int(hdr.h) != h) return ERR_DIMS;
  size_t stride = hdr.w;
  std::vector<uint8_t> raw((stride + 1) * hdr.h);
  rc = zlib_inflate_all(idat, raw);
  if (rc) return rc;
  rc = png_unfilter(raw, hdr.h, stride, 1);
  if (rc) return rc;
  for (uint32_t y = 0; y < hdr.h; y++)
    std::memcpy(out + size_t(y) * hdr.w, &raw[y * (stride + 1) + 1], stride);
  return 0;
}

// Encode an (h, w) uint8 index tile as a palette PNG at `path`.
// `pal` is npal*3 RGB bytes; `level` the zlib level (1 is `predict`'s).
int rs_encode_palette_png(const char* path, const uint8_t* idx, int h, int w, const uint8_t* pal,
                          int npal, int level) {
  std::vector<uint8_t> bytes;
  int rc = encode_palette_png(idx, h, w, w, pal, npal, level, bytes);
  if (rc) return rc;
  return write_file(path, bytes);
}

// Encode from the predict fast path's parity-blocked layout
// (robosat_tpu_torch/models/layers.py:space_to_depth2): blocked is
// (h/2, w/2, 4) uint8 channels-last, fine[2i+di][2j+dj] = blocked[i][j][2*di+dj];
// the interleave happens during scanline assembly, so the numpy
// depth-to-space pass becomes part of the encode walk.
int rs_encode_palette_png_d2s(const char* path, const uint8_t* blocked, int h, int w,
                              const uint8_t* pal, int npal, int level) {
  if ((h | w) & 1) return ERR_DIMS;
  int hh = h / 2, ww = w / 2;
  std::vector<uint8_t> fine(size_t(h) * w);
  for (int i = 0; i < hh; i++) {
    const uint8_t* src = blocked + size_t(i) * ww * 4;
    uint8_t* top = &fine[size_t(2 * i) * w];
    uint8_t* bot = top + w;
    for (int j = 0; j < ww; j++) {
      top[2 * j] = src[4 * j];
      top[2 * j + 1] = src[4 * j + 1];
      bot[2 * j] = src[4 * j + 2];
      bot[2 * j + 1] = src[4 * j + 3];
    }
  }
  std::vector<uint8_t> bytes;
  int rc = encode_palette_png(fine.data(), h, w, w, pal, npal, level, bytes);
  if (rc) return rc;
  return write_file(path, bytes);
}

}  // extern "C"
