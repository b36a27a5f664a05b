// JPEG decode (libjpeg) to packed RGB8 for the port's host IO, with a
// plain C interface for ctypes. The JAX package's native runtime decodes
// JPEG the same way; PNG is decoded in Python (utils/frames.py).

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>

extern "C" {

void vn_free(void* p) { free(p); }

struct VnJpegErr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

static void vn_jpeg_error_exit(j_common_ptr cinfo) {
    VnJpegErr* err = reinterpret_cast<VnJpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Decode JPEG bytes to RGB8 [h, w, 3]. Returns a malloc'd buffer (free it
// with vn_free) and writes its size to *w, *h; nullptr on a decode error.
uint8_t* vn_decode_jpeg(const uint8_t* bytes, size_t len, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    VnJpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = vn_jpeg_error_exit;
    uint8_t* volatile out = nullptr;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        free(out);
        return nullptr;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes, len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    size_t stride = static_cast<size_t>(*w) * 3;
    out = static_cast<uint8_t*>(malloc(stride * *h));
    if (!out) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + stride * cinfo.output_scanline;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return out;
}

}  // extern "C"
