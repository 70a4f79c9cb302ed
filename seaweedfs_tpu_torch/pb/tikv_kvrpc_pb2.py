# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tikv_kvrpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import tikv_meta_pb2 as tikv__meta__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10tikv_kvrpc.proto\x12\x07kvrpcpb\x1a\x0ftikv_meta.proto\"\x1e\n\x0bRegionError\x12\x0f\n\x07message\x18\x01 \x01(\t\"c\n\x07\x43ontext\x12\x11\n\tregion_id\x18\x01 \x01(\x04\x12)\n\x0cregion_epoch\x18\x02 \x01(\x0b\x32\x13.metapb.RegionEpoch\x12\x1a\n\x04peer\x18\x03 \x01(\x0b\x32\x0c.metapb.Peer\"I\n\x06KvPair\x12#\n\x05\x65rror\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\"K\n\rRawGetRequest\x12!\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x10.kvrpcpb.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x03 \x01(\t\"m\n\x0eRawGetResponse\x12*\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\x11\n\tnot_found\x18\x04 \x01(\x08\"x\n\rRawPutRequest\x12!\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x10.kvrpcpb.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x04 \x01(\t\x12\x0b\n\x03ttl\x18\x05 \x01(\x04\x12\x0f\n\x07\x66or_cas\x18\x06 \x01(\x08\"K\n\x0eRawPutResponse\x12*\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"_\n\x10RawDeleteRequest\x12!\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x10.kvrpcpb.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x03 \x01(\t\x12\x0f\n\x07\x66or_cas\x18\x04 \x01(\x08\"N\n\x11RawDeleteResponse\x12*\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x95\x01\n\x0eRawScanRequest\x12!\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x10.kvrpcpb.Context\x12\x11\n\tstart_key\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\r\x12\x10\n\x08key_only\x18\x04 \x01(\x08\x12\n\n\x02\x63\x66\x18\x05 \x01(\t\x12\x0f\n\x07reverse\x18\x06 \x01(\x08\x12\x0f\n\x07\x65nd_key\x18\x07 \x01(\x0c\"[\n\x0fRawScanResponse\x12*\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\x1c\n\x03kvs\x18\x02 \x03(\x0b\x32\x0f.kvrpcpb.KvPair\"j\n\x15RawDeleteRangeRequest\x12!\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x10.kvrpcpb.Context\x12\x11\n\tstart_key\x18\x02 \x01(\x0c\x12\x0f\n\x07\x65nd_key\x18\x03 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x04 \x01(\t\"S\n\x16RawDeleteRangeResponse\x12*\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x14.kvrpcpb.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tikv_kvrpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REGIONERROR._serialized_start=46
  _REGIONERROR._serialized_end=76
  _CONTEXT._serialized_start=78
  _CONTEXT._serialized_end=177
  _KVPAIR._serialized_start=179
  _KVPAIR._serialized_end=252
  _RAWGETREQUEST._serialized_start=254
  _RAWGETREQUEST._serialized_end=329
  _RAWGETRESPONSE._serialized_start=331
  _RAWGETRESPONSE._serialized_end=440
  _RAWPUTREQUEST._serialized_start=442
  _RAWPUTREQUEST._serialized_end=562
  _RAWPUTRESPONSE._serialized_start=564
  _RAWPUTRESPONSE._serialized_end=639
  _RAWDELETEREQUEST._serialized_start=641
  _RAWDELETEREQUEST._serialized_end=736
  _RAWDELETERESPONSE._serialized_start=738
  _RAWDELETERESPONSE._serialized_end=816
  _RAWSCANREQUEST._serialized_start=819
  _RAWSCANREQUEST._serialized_end=968
  _RAWSCANRESPONSE._serialized_start=970
  _RAWSCANRESPONSE._serialized_end=1061
  _RAWDELETERANGEREQUEST._serialized_start=1063
  _RAWDELETERANGEREQUEST._serialized_end=1169
  _RAWDELETERANGERESPONSE._serialized_start=1171
  _RAWDELETERANGERESPONSE._serialized_end=1254
# @@protoc_insertion_point(module_scope)
